"""Tkinter desktop app.

Port of ``othello_reinforcement_learning_test_tpu/apps/gui/app.py``: board +
info panel + buttons (New Game / Undo / AI Move / Hint / Pass), simulations
slider 10-200, model loading, AI moves on a daemon thread marshalled back via
``root.after``, hint at ``max(10, sims // 2)``. Session logic lives in the
port's :class:`~..web.game_manager.GameManager` on ``device`` (CUDA unless
``"cpu"`` is asked for). One stated difference: "Load Model..." asks for a
``.pt`` file, where the JAX app asks for an orbax checkpoint directory.
"""

from __future__ import annotations

import threading
import tkinter as tk
from tkinter import filedialog, messagebox
from typing import Optional

from ..web.game_manager import GameManager
from .board_ui import InfoPanel, OthelloBoardUI


class OthelloApp:
    def __init__(self, root: tk.Tk, model_path: Optional[str] = None,
                 model_dir: str = "data/models", device=None):
        self.root = root
        root.title("Othello AlphaZero (PyTorch/H100)")
        self.gm = GameManager(model_dir=model_dir, device=device)
        self._evals = None

        main = tk.Frame(root)
        main.pack(padx=10, pady=10)
        self.board_ui = OthelloBoardUI(
            main, size=self.gm.engine.size, on_click=self._on_board_click
        )
        self.board_ui.grid(row=0, column=0, rowspan=2)

        side = tk.Frame(main)
        side.grid(row=0, column=1, sticky="n", padx=(12, 0))
        self.info = InfoPanel(side)
        self.info.pack(anchor="w")

        btns = tk.Frame(side)
        btns.pack(anchor="w", pady=8)
        self.btn_new = tk.Button(btns, text="New Game", command=self.new_game)
        self.btn_undo = tk.Button(btns, text="Undo", command=self.undo)
        self.btn_ai = tk.Button(btns, text="AI Move", command=self.ai_move)
        self.btn_hint = tk.Button(btns, text="Hint", command=self.show_hint)
        self.btn_pass = tk.Button(btns, text="Pass", command=self.pass_move)
        for b in (self.btn_new, self.btn_undo, self.btn_ai, self.btn_hint,
                  self.btn_pass):
            b.pack(fill="x", pady=2)

        tk.Label(side, text="AI simulations").pack(anchor="w", pady=(10, 0))
        self.sims_var = tk.IntVar(value=100)
        self.sims_scale = tk.Scale(
            side, from_=10, to=200, orient="horizontal",
            variable=self.sims_var, command=self._sims_changed,
        )
        self.sims_scale.pack(fill="x")

        menubar = tk.Menu(root)
        filemenu = tk.Menu(menubar, tearoff=0)
        filemenu.add_command(label="Load Model...", command=self.load_model_dialog)
        filemenu.add_command(label="New Game", command=self.new_game)
        filemenu.add_separator()
        filemenu.add_command(label="Quit", command=root.destroy)
        menubar.add_cascade(label="Game", menu=filemenu)
        root.config(menu=menubar)

        if model_path:
            self.load_model(model_path)
        self.refresh()

    # -- rendering ---------------------------------------------------------
    def refresh(self) -> None:
        state = self.gm.state_dict()
        self.board_ui.render(
            state["board"], state["legal_moves"], state["last_move"], self._evals
        )
        self.info.update_state(state)
        thinking = state["is_ai_thinking"]
        self.btn_undo.config(
            state="normal" if state["can_undo"] and not thinking else "disabled")
        ai_ok = state["model_loaded"] and not thinking and not state["is_game_over"]
        self.btn_ai.config(state="normal" if ai_ok else "disabled")
        self.btn_hint.config(
            state="normal" if state["model_loaded"] and not thinking else "disabled")
        # pass is the only legal action when no square is playable
        must_pass = (
            not state["is_game_over"]
            and state["legal_moves"] == [self.gm.engine.pass_action]
        )
        self.btn_pass.config(
            state="normal" if must_pass and not thinking else "disabled")

    # -- actions -----------------------------------------------------------
    def new_game(self) -> None:
        ok, err = self.gm.new_game()
        self._evals = None
        self.info.set_message("" if ok else (err or ""))
        self.refresh()

    def pass_move(self) -> None:
        ok, err = self.gm.make_move(self.gm.engine.pass_action)
        if not ok:
            self.info.set_message(err or "cannot pass")
            return
        self._evals = None
        self.info.set_message("passed")
        self.refresh()
        if self.gm.state_dict()["model_loaded"] and not self.gm.is_game_over():
            self.root.after(500, self.ai_move)

    def undo(self) -> None:
        ok, err = self.gm.undo()
        if not ok and err:
            self.info.set_message(err)
        self._evals = None
        self.refresh()

    def _on_board_click(self, pos: int) -> None:
        if self.gm.is_ai_thinking or self.gm.is_game_over():
            return
        ok, err = self.gm.make_move(pos)
        if not ok:
            if err and "illegal" not in err:
                self.info.set_message(err)
            return
        self._evals = None
        self.info.set_message("")
        self.refresh()
        if self.gm.state_dict()["model_loaded"] and not self.gm.is_game_over():
            self.root.after(500, self.ai_move)

    def ai_move(self) -> None:
        """AI on a daemon thread; UI updates marshalled back with
        ``root.after``."""
        state = self.gm.state_dict()
        if not state["model_loaded"] or state["is_ai_thinking"] or \
                state["is_game_over"]:
            return
        self.info.set_message("AI thinking…")
        self.refresh()

        def worker():
            ok, err = self.gm.execute_ai_move()
            self.root.after(0, lambda: self._ai_done(ok, err))

        threading.Thread(target=worker, daemon=True).start()

    def _ai_done(self, ok: bool, err: Optional[str]) -> None:
        self._evals = None
        self.info.set_message("" if ok else (err or "AI move failed"))
        self.refresh()

    def show_hint(self) -> None:
        """Eval overlay at max(10, sims // 2) simulations."""
        self.info.set_message("computing hint…")

        def worker():
            evals = self.gm.hint()
            def done():
                self._evals = evals or None
                self.info.set_message(
                    f"hint ({len(evals)} moves)" if evals else "no model loaded")
                self.refresh()
            self.root.after(0, done)

        threading.Thread(target=worker, daemon=True).start()

    def _sims_changed(self, _value) -> None:
        self.gm.set_simulations(int(self.sims_var.get()))

    # -- model management --------------------------------------------------
    def load_model(self, path: str) -> None:
        ok, err = self.gm.load_model(path)
        if ok:
            self.info.set_message(f"model loaded: {path}")
        else:
            self.info.set_message(f"load failed: {err}")
        self.refresh()

    def load_model_dialog(self) -> None:
        path = filedialog.askopenfilename(
            title="Select model file", initialdir=self.gm.model_dir,
            filetypes=[("PyTorch models", "*.pt *.pth"), ("All files", "*")])
        if path:
            self.load_model(path)

    def show_error(self, msg: str) -> None:  # pragma: no cover - dialogs
        messagebox.showerror("Othello", msg)
