"""Desktop GUI entry point.

    python -m othello_reinforcement_learning_test_tpu_torch.run_gui [--device cpu] [--model m.pt]

Port of the root ``run_gui.py`` (which stays JAX-only), with its flags and
defaults. ``--device auto`` is CUDA and raises without it: no health check,
no fall back to the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Othello AlphaZero GUI")
    parser.add_argument("--model", default=None, help="checkpoint (.pt) to preload")
    parser.add_argument("--model-dir", default="data/models")
    parser.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto: CUDA (required)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    import tkinter as tk

    from .apps.gui import OthelloApp

    root = tk.Tk()
    OthelloApp(root, model_path=args.model, model_dir=args.model_dir, device=device)
    root.mainloop()


if __name__ == "__main__":
    main()
