"""GUI demo: opens the app and plays a few scripted moves, so that the
board and info wiring can be seen without interacting.

    python -m othello_reinforcement_learning_test_tpu_torch.demo_gui [--model m.pt]

Port of the root ``demo_gui.py`` (which stays JAX-only), with its one flag;
the session runs on CUDA, which it requires.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default=None)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    import tkinter as tk

    from .apps.gui import OthelloApp

    root = tk.Tk()
    app = OthelloApp(root, model_path=args.model)

    moves = [19, 18, 26]  # D3, C3, C4

    def step(i=0):
        if i < len(moves):
            app._on_board_click(moves[i])
            root.after(800, step, i + 1)

    root.after(800, step)
    root.mainloop()


if __name__ == "__main__":
    main()
