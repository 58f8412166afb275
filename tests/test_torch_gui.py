"""The port's Tk app against the JAX one, in lockstep, without a display.

``tests/fake_tk.py`` stands in for tkinter (as in ``test_gui_headless.py``),
so both apps' click handling, draw operations, button state machine,
slider, menu and threaded AI marshalling run for real. Each step is done to
both apps; then every canvas draw operation, every button's state and the
info panel's three strings must be equal. The JAX session runs its engine
and search jitted and both play the stub network
(``jax_frontend_stub.py``). The port's session runs on the CPU, asked for
by name.

Stated differences, checked as such: the window title names the port, and
"Load Model..." asks for a ``.pt`` file where the JAX app asks for an orbax
directory.
"""

import importlib
import sys
import threading

import numpy as np
import pytest
import torch

import fake_tk
from jax_frontend_stub import install_players, jit_jax_session
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as ckpt

BUTTONS = ("btn_new", "btn_undo", "btn_ai", "btn_hint", "btn_pass")
SEED = 46  # its game of random clicks passes three times


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def apps(monkeypatch, tmp_path):
    """The JAX and the port ``OthelloApp`` on the fake toolkit."""
    monkeypatch.setitem(sys.modules, "tkinter", fake_tk)
    monkeypatch.setitem(sys.modules, "tkinter.filedialog", fake_tk.filedialog)
    monkeypatch.setitem(sys.modules, "tkinter.messagebox", fake_tk.messagebox)
    calls = []
    for name in ("askdirectory", "askopenfilename"):
        monkeypatch.setattr(fake_tk.filedialog, name,
                            lambda _n=name, **kw: calls.append((_n, kw)) or
                            fake_tk.filedialog.return_value)
    monkeypatch.setattr(fake_tk.filedialog, "return_value", "")
    for name in list(sys.modules):  # re-import the GUI modules on the fake toolkit
        if ".apps.gui" in name or name.endswith(("_torch.run_gui", "_torch.demo_gui")):
            monkeypatch.delitem(sys.modules, name)
    jax_mod = importlib.import_module("othello_reinforcement_learning_test_tpu.apps.gui.app")
    port_mod = importlib.import_module("othello_reinforcement_learning_test_tpu_torch.apps.gui.app")
    roots = fake_tk.Tk(), fake_tk.Tk()
    japp = jax_mod.OthelloApp(roots[0], model_dir=str(tmp_path))
    tapp = port_mod.OthelloApp(roots[1], model_dir=str(tmp_path), device="cpu")
    jit_jax_session(monkeypatch, japp.gm)
    yield japp, tapp, calls
    for root in roots:
        root.destroy()


def view(app):
    return (list(app.board_ui.canvas.items), {b: getattr(app, b).cget("state") for b in BUTTONS},
            app.info.turn_var.get(), app.info.score_var.get(), app.info.message_var.get())


def step(japp, tapp, action):
    """``action(app)`` on both apps, each joined with the threads it
    started; then their views must be equal."""
    for app in (japp, tapp):
        before = set(threading.enumerate())
        action(app)
        for t in set(threading.enumerate()) - before:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not app.gm.is_ai_thinking
    assert view(tapp) == view(japp)
    return tapp.gm.state_dict()


def click(pos):
    def action(app):
        r, c = divmod(pos, app.board_ui.size)
        app.board_ui.canvas.event_generate("<Button-1>", x=c * app.board_ui.cell + 5,
                                           y=r * app.board_ui.cell + 5)
    return action


def test_titles_name_their_package(apps):
    japp, tapp, _ = apps
    assert japp.root.title() == "Othello AlphaZero (TPU)"
    assert tapp.root.title() == "Othello AlphaZero (PyTorch/H100)"
    assert view(tapp) == view(japp)


def test_a_game_of_clicks_matches_jax(apps):
    """A whole game of seeded random clicks (no model): illegal clicks,
    undo, the pass button, game over."""
    japp, tapp, _ = apps
    rng = np.random.default_rng(SEED)
    step(japp, tapp, click(0))  # illegal: ignored
    plies = passes = 0
    while True:
        s = step(japp, tapp, lambda app: None)
        if s["is_game_over"]:
            break
        if plies == 5:
            s = step(japp, tapp, lambda app: app.btn_undo.invoke())
        move = int(rng.choice(s["legal_moves"]))
        if move == 64:
            assert tapp.btn_pass.cget("state") == "normal"
            passes += 1
            step(japp, tapp, lambda app: app.btn_pass.invoke())
        else:
            assert tapp.btn_pass.cget("state") == "disabled"
            step(japp, tapp, click(move))
        plies += 1
    assert passes == 3 and plies > 50
    assert "wins" in tapp.info.turn_var.get() or tapp.info.turn_var.get() == "Draw"
    step(japp, tapp, click(19))  # after game over: ignored
    s = step(japp, tapp, lambda app: app.btn_new.invoke())
    assert s["move_count"] == 0


def test_slider_and_menu_match_jax(apps):
    japp, tapp, calls = apps
    for value in (150, 200, 10):
        step(japp, tapp, lambda app: app.sims_scale.set(value))
        assert japp.gm.ai_simulations == tapp.gm.ai_simulations == value
    menus = []
    for app in (japp, tapp):
        kind, kw = app.root.kw["menu"].entries[0]
        menus.append((kind, kw["label"], [(k, e.get("label")) for k, e in kw["menu"].entries]))
    assert menus[0] == menus[1] == ("cascade", "Game", [
        ("command", "Load Model..."), ("command", "New Game"), ("separator", None),
        ("command", "Quit")])
    # the stated difference: a .pt file where the JAX app asks for a directory
    step(japp, tapp, lambda app: app.load_model_dialog())  # cancelled in both
    (jname, jkw), (tname, tkw) = calls
    assert (jname, tname) == ("askdirectory", "askopenfilename")
    assert jkw["initialdir"] == tkw["initialdir"] == tapp.gm.model_dir
    assert ("PyTorch models", "*.pt *.pth") in tkw["filetypes"]


def test_ai_move_and_hint_match_jax(apps):
    japp, tapp, _ = apps
    install_players(japp.gm, tapp.gm)
    s = step(japp, tapp, lambda app: app.refresh())
    assert tapp.btn_ai.cget("state") == tapp.btn_hint.cget("state") == "normal"
    for pos in (19, None, None):  # a click and the AI's reply; the AI button twice
        s = step(japp, tapp, click(pos) if pos is not None else lambda app: app.btn_ai.invoke())
        assert s["last_ai_move"] is not None
        s = step(japp, tapp, lambda app: app.btn_hint.invoke())
        texts = [a for k, a, kw in tapp.board_ui.canvas.items if k == "text"]
        assert tapp._evals and len(texts) == len(tapp._evals)
        assert set(tapp._evals) <= set(s["legal_moves"])
        assert tapp.info.message_var.get() == f"hint ({len(tapp._evals)} moves)"
    assert s["move_count"] == 4
    step(japp, tapp, lambda app: app.btn_undo.invoke())


def test_port_app_loads_a_pt_file(apps, tmp_path, monkeypatch):
    _, tapp, calls = apps
    path = ckpt.save(str(tmp_path / "tiny.pt"),
                     {"model": from_jax_variables(init_numpy_variables(1, 8, 0)), "step": 0,
                      "iteration": 0},
                     {"model": {"num_blocks": 1, "num_filters": 8}})
    monkeypatch.setattr(fake_tk.filedialog, "return_value", path)
    tapp.load_model_dialog()
    assert tapp.gm.state_dict()["model_path"] == path
    assert tapp.info.message_var.get() == f"model loaded: {path}"
    tapp.load_model(str(tmp_path))  # a directory: refused, naming the converter
    assert "scripts/orbax_to_torch.py" in tapp.info.message_var.get()


def test_gui_entry_points(apps, tmp_path):
    from othello_reinforcement_learning_test_tpu_torch import demo_gui, run_gui

    run_gui.main(["--device", "cpu", "--model-dir", str(tmp_path)])  # mainloop returns at once
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_gui.main(["--model-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_gui.main([])
