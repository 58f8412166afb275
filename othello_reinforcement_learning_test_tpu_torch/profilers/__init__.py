"""The port's profilers: the JAX package's four ``scripts/profile_*.py``
measurement tools as modules of the port, each runnable as ``python -m
othello_reinforcement_learning_test_tpu_torch.profilers.<name>``:

- ``profile_mcts``: a search split into tree+env and forward;
- ``profile_mcts_parts``: one simulation split into its five parts;
- ``profile_forward_parts``: the fused forward split into stem, trunk and
  heads;
- ``profile_move_glue``: a self-play ply's glue, part by part, and the
  lockstep game lengths.

They run on CUDA unless ``--device cpu`` is asked for, and time with one
harness (``common.py``).
"""
