#!/usr/bin/env python
"""Convert a JAX trainer checkpoint into a model file of the PyTorch port.

    python scripts/orbax_to_torch.py data/models/final_model [final_model.pt]

The source is an orbax checkpoint directory of the JAX package (either of
its formats) with its ``.config.json`` sidecar, read as the JAX
``MCTSPlayer.from_checkpoint`` reads it. The output (default: the
directory's path with ``.pt``) is the port's format-1 checkpoint,
``{"model", "step", "iteration"}`` with the config in its own
``.config.json`` sidecar, which the port's ``MCTSPlayer.from_checkpoint``,
web session (``run_web``) and GUI (``run_gui``) load.

The file is a model for playing, not a run to resume: the optimizer's
momentum, the replay buffer and the generators are not carried.

This script imports both packages, so it lives outside the port, which
imports no JAX. It runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository's packages


def load_jax_checkpoint(path: str) -> Tuple[Dict, int, int, Dict]:
    """``(variables, step, iteration, config)`` of a JAX trainer checkpoint,
    its variables as numpy ``{params, batch_stats}``."""
    import jax
    import jax.numpy as jnp

    from othello_reinforcement_learning_test_tpu.models.resnet import (
        OthelloResNet,
        init_variables,
    )
    from othello_reinforcement_learning_test_tpu.train import checkpoint as ckpt_lib
    from othello_reinforcement_learning_test_tpu.train.trainer import TrainState, make_optimizer

    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: not an orbax checkpoint directory")
    cfg = ckpt_lib.load_config(path) or {}
    mc = cfg.get("model", {})
    model = OthelloResNet(
        num_blocks=int(mc.get("num_blocks", 10)),
        num_filters=int(mc.get("num_filters", 128)),
        board_size=int(cfg.get("game", {}).get("size", mc.get("board_size", 8))),
    )
    variables = init_variables(model, jax.random.PRNGKey(0))
    template = TrainState(
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=make_optimizer(cfg).init(variables["params"]),
        step=jnp.int32(0),
        iteration=jnp.int32(0),
    )
    state = ckpt_lib.load_train_state(path, template)
    host = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return host, int(state.step), int(state.iteration), cfg


def convert(src: str, dst: Optional[str] = None) -> str:
    """Write the port's ``.pt`` for the JAX checkpoint ``src``; returns its
    path."""
    from othello_reinforcement_learning_test_tpu_torch.models.convert import from_jax_variables
    from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as port_ckpt

    variables, step, iteration, cfg = load_jax_checkpoint(src)
    dst = dst or os.path.normpath(src) + ".pt"
    state = {"model": from_jax_variables(variables), "step": step, "iteration": iteration}
    return port_ckpt.save(dst, state, cfg)


def build_parser() -> argparse.ArgumentParser:
    doc = __doc__.split("\n\n")
    parser = argparse.ArgumentParser(description=doc[0], epilog="\n\n".join(doc[2:4]),
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("src", help="orbax checkpoint directory (with .config.json beside it)")
    parser.add_argument("dst", nargs="?", default=None, help="output .pt (default: <src>.pt)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")  # before the first backend use
    print(convert(args.src, args.dst))


if __name__ == "__main__":
    main()
