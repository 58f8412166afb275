"""The port's strength studies: the JAX package's research scripts
``scripts/elo_ladder.py``, ``standard_rules_arena.py`` and
``eval_flagship_r4.py`` / ``eval_flagship_r5_ext.py`` as modules of the
port, each runnable as ``python -m
othello_reinforcement_learning_test_tpu_torch.studies.<name>``:

- ``elo_ladder``: the round robin of networks and anchors, and the
  anchored Bradley-Terry fit with bootstrap intervals;
- ``standard_rules_arena``: the symmetry-augmentation pair under the
  standard rules;
- ``eval_flagship``: a flagship network against a preset list of
  opponents (``--preset r4|r5_ext``).

They play through the plain bf16 eval forward, as the JAX scripts do, on
CUDA unless ``--device cpu`` is asked for, and share players, the network
lookup and the pair loop (``common.py``).
"""
