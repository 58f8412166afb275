"""Tkinter board canvas + info panel.

Port of ``othello_reinforcement_learning_test_tpu/apps/gui/board_ui.py``
(pure Tk, the same widgets and draw operations): canvas grid, stones,
legal-move dots, last-move marker, 0-100 eval overlay colored by value, and
a side panel with turn/score/message.
"""

from __future__ import annotations

import tkinter as tk
from typing import Callable, Dict, List, Optional

BOARD_COLOR = "#1d7a46"
LINE_COLOR = "#145c34"
HINT_DOT = "#d9ffe9"


class OthelloBoardUI(tk.Frame):
    def __init__(self, master, size: int = 8, cell_px: int = 64,
                 on_click: Optional[Callable[[int], None]] = None):
        super().__init__(master)
        self.size = size
        self.cell = cell_px
        self.on_click = on_click
        px = size * cell_px
        self.canvas = tk.Canvas(self, width=px, height=px, bg=BOARD_COLOR,
                                highlightthickness=0)
        self.canvas.pack()
        self.canvas.bind("<Button-1>", self._clicked)

    def _clicked(self, event) -> None:
        col = event.x // self.cell
        row = event.y // self.cell
        if 0 <= row < self.size and 0 <= col < self.size and self.on_click:
            self.on_click(int(row * self.size + col))

    def render(
        self,
        board: List[List[int]],
        legal: List[int],
        last_move: Optional[int] = None,
        evaluations: Optional[Dict[int, int]] = None,
    ) -> None:
        c = self.canvas
        c.delete("all")
        px = self.size * self.cell
        for i in range(self.size + 1):
            c.create_line(0, i * self.cell, px, i * self.cell, fill=LINE_COLOR)
            c.create_line(i * self.cell, 0, i * self.cell, px, fill=LINE_COLOR)
        legal_set = set(legal)
        pad = self.cell // 10
        for r in range(self.size):
            for col in range(self.size):
                v = board[r][col]
                x0, y0 = col * self.cell, r * self.cell
                x1, y1 = x0 + self.cell, y0 + self.cell
                pos = r * self.size + col
                if v == 1:
                    c.create_oval(x0 + pad, y0 + pad, x1 - pad, y1 - pad,
                                  fill="#111111", outline="#000000")
                elif v == -1:
                    c.create_oval(x0 + pad, y0 + pad, x1 - pad, y1 - pad,
                                  fill="#f4f4f4", outline="#aaaaaa")
                elif pos in legal_set:
                    d = self.cell // 2 - self.cell // 10
                    c.create_oval(x0 + d, y0 + d, x1 - d, y1 - d,
                                  fill=HINT_DOT, outline="")
                if evaluations and pos in evaluations:
                    score = evaluations[pos]
                    # red (0) -> yellow (50) -> green (100)
                    hue = int(score * 1.2)
                    color = f"#{self._hue_rgb(hue)}"
                    c.create_text(
                        x0 + self.cell // 2, y0 + self.cell // 2,
                        text=str(score), fill=color,
                        font=("TkDefaultFont", self.cell // 3, "bold"),
                    )
        if last_move is not None and 0 <= last_move < self.size * self.size:
            r, col = divmod(last_move, self.size)
            x0, y0 = col * self.cell, r * self.cell
            c.create_oval(x0 + 2, y0 + 2, x0 + self.cell - 2, y0 + self.cell - 2,
                          outline="#4fc3f7", width=3)

    @staticmethod
    def _hue_rgb(hue: int) -> str:
        """0..120 hue (red->green) to hex rgb at full saturation."""
        import colorsys

        r, g, b = colorsys.hsv_to_rgb(max(0, min(120, hue)) / 360.0, 0.85, 0.95)
        return f"{int(r * 255):02x}{int(g * 255):02x}{int(b * 255):02x}"


class InfoPanel(tk.Frame):
    """Turn / score / status messages."""

    def __init__(self, master):
        super().__init__(master)
        self.turn_var = tk.StringVar(value="Black ● to move")
        self.score_var = tk.StringVar(value="● 2  -  ○ 2")
        self.message_var = tk.StringVar(value="")
        tk.Label(self, textvariable=self.turn_var,
                 font=("TkDefaultFont", 14, "bold")).pack(anchor="w", pady=2)
        tk.Label(self, textvariable=self.score_var,
                 font=("TkDefaultFont", 13)).pack(anchor="w", pady=2)
        tk.Label(self, textvariable=self.message_var, fg="#2060a0",
                 wraplength=220, justify="left").pack(anchor="w", pady=6)

    def update_state(self, state: Dict) -> None:
        if state["is_game_over"]:
            w = state["winner"]
            self.turn_var.set(
                "Black ● wins!" if w == 1 else
                "White ○ wins!" if w == -1 else "Draw")
        else:
            self.turn_var.set(
                "Black ● to move" if state["current_player"] == 1
                else "White ○ to move")
        self.score_var.set(
            f"● {state['black_count']}  -  ○ {state['white_count']}")

    def set_message(self, text: str) -> None:
        self.message_var.set(text)
