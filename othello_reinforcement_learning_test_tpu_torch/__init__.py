"""PyTorch/CUDA port of the AlphaZero Othello system.

Mirrors the layout of the JAX package ``othello_reinforcement_learning_test_tpu``
(``ops/``, ``models/``, ``search/``, ``train/``, ``utils/``), which stays the
reference every module here is tested against. This package imports torch
and numpy only; the hand-written CUDA kernels live in ``csrc/`` and are built
with ``nvcc`` on first use (``kernels/build.py``).
"""
