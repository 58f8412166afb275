"""The port's web frontends against the JAX ones, on the CPU.

- the package facades: the same ``__all__`` as the JAX package's, every
  name the port's own;
- the session: the port's ``GameManager`` and the JAX one, each with the
  stub player of ``torch_stub_net.py`` (``jax_frontend_stub.py``), driven
  through one seeded whole game under both rule sets (human moves drawn
  from numpy, every other ply an AI move, undo, hints, refusals): every
  ``state_dict()`` and every returned tuple equal; hints with the same
  moves and values within 1 (two float32 searches round a Q value at .5
  apart);
- the stdlib servers: one REST script against the JAX and the port server,
  status codes and JSON bodies equal (hints as above); the static copy
  byte-identical but for the two ``index.html`` strings that name the port;
  every endpoint the JS client calls served;
- the schemas: fields, defaults and ``model_dump()`` equal to the pydantic
  models', and request validation with the same outcome;
- the FastAPI adapter (under a fake ``fastapi`` module, as
  ``test_fastapi_adapter.py``): the stdlib server's routes, a game through
  its handlers;
- model files: ``list_models`` and ``load_model`` on port checkpoints,
  reference-format files, TorchScript exports and orbax directories, and an
  AI move over HTTP with a 1x8 port checkpoint;
- the entry points: their parsers equal to the root scripts', ``--device
  auto`` raises without CUDA, ``run_web --device cpu`` serves the client.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from pydantic_core import PydanticUndefined

from jax_frontend_stub import install_players, jax_session, port_session
from othello_reinforcement_learning_test_tpu.apps.web import schemas as jschemas
from othello_reinforcement_learning_test_tpu.apps.web import server as jserver
from othello_reinforcement_learning_test_tpu_torch import run_gui, run_web
from othello_reinforcement_learning_test_tpu_torch.apps.web import game_manager as tgm_lib
from othello_reinforcement_learning_test_tpu_torch.apps.web import schemas as tschemas
from othello_reinforcement_learning_test_tpu_torch.apps.web import server as tserver
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as ckpt
from test_js_client import extract_fetch_calls, extract_state_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = "othello_reinforcement_learning_test_tpu_torch"
JAX_PKG = "othello_reinforcement_learning_test_tpu"
REF_PT = os.path.join(REPO, "results", "parity_models", "ref_seed7.pt")
STATIC = {pkg: os.path.join(REPO, pkg, "apps", "web", "static") for pkg in (PORT_PKG, JAX_PKG)}
# the two strings of index.html that name the port
INDEX_NAMES = [("<title>Othello AlphaZero (TPU)</title>",
                "<title>Othello AlphaZero (PyTorch/H100)</title>"),
               ('<p class="subtitle">TPU-native self-play engine</p>',
                '<p class="subtitle">PyTorch/CUDA port for the NVIDIA H100</p>')]
ROUTES = {("POST", "/api/game/new"), ("GET", "/api/game/state"), ("POST", "/api/game/move"),
          ("POST", "/api/game/undo"), ("POST", "/api/game/ai-move"),
          ("GET", "/api/game/ai-status"), ("GET", "/api/game/hint"),
          ("POST", "/api/ai/load-model"), ("PUT", "/api/ai/simulations"),
          ("GET", "/api/ai/simulations"), ("GET", "/api/ai/models")}
SEED = 12  # its standard-rules game has two passes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op pool at one thread: the searches here are chains of
    tiny ops, which many threads per test worker turn into spin-waits."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the facades -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ops", "models", "search", "train", "utils"])
def test_facade_exports_the_jax_names(name):
    port = importlib.import_module(f"{PORT_PKG}.{name}")
    ref = importlib.import_module(f"{JAX_PKG}.{name}")
    assert port.__all__ == ref.__all__
    for n in port.__all__:
        obj = getattr(port, n)
        if isinstance(obj, types.ModuleType):
            assert obj.__name__.startswith(PORT_PKG), n
        elif callable(obj):
            assert obj.__module__.startswith(PORT_PKG), n


def test_ops_facade_imports_no_trainer():
    code = (f"import sys, {PORT_PKG}.ops, {PORT_PKG}.search\n"
            "print([m for m in sys.modules if m.endswith('.trainer') or 'tensorboard' in m])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


# -- the session -----------------------------------------------------------------


def both(jgm, tgm, method, *args):
    a, b = getattr(jgm, method)(*args), getattr(tgm, method)(*args)
    assert a == b, (method, args, a, b)
    return b


def same_state(jgm, tgm) -> dict:
    a, b = jgm.state_dict(), tgm.state_dict()
    assert a == b
    return b


def same_hint(a: dict, b: dict) -> dict:
    assert sorted(a) == sorted(b)
    assert all(abs(a[k] - b[k]) <= 1 for k in a), (a, b)
    assert all(0 <= v <= 100 for v in b.values())
    return b


@pytest.mark.parametrize("rules", ["reference", "standard"])
def test_session_matches_jax(rules, monkeypatch, tmp_path):
    jgm, tgm = jax_session(monkeypatch, rules, str(tmp_path)), port_session(rules, str(tmp_path))
    same_state(jgm, tgm)
    for method in ("execute_ai_move", "start_ai_move", "undo", "hint"):
        both(jgm, tgm, method)  # no model, nothing to undo
    both(jgm, tgm, "make_move", 0)  # illegal
    for n in (9999, 1, 37, "120"):
        both(jgm, tgm, "set_simulations", n)
    install_players(jgm, tgm)
    rng = np.random.default_rng(SEED)
    ply, hints, passes = 0, 0, 0
    while True:
        s = same_state(jgm, tgm)
        if s["is_game_over"]:
            break
        passes += s["legal_moves"] == [64]
        if ply == 7:
            both(jgm, tgm, "undo")
            s = same_state(jgm, tgm)
        if ply % 10 == 3:
            same_hint(jgm.hint(), tgm.hint())
            hints += 1
        if s["current_player"] == 1:
            move = int(rng.choice(s["legal_moves"]))
            assert both(jgm, tgm, "make_move", move) == (True, None)
        else:
            assert both(jgm, tgm, "execute_ai_move") == (True, None)
        ply += 1
    assert ply > 50 and hints >= 5 and s["winner"] in (-1, 0, 1)
    assert passes == (2 if rules == "standard" else 0)
    for method, args in (("make_move", (64,)), ("execute_ai_move", ()), ("start_ai_move", ())):
        assert both(jgm, tgm, method, *args) == (False, "game is over")
    both(jgm, tgm, "new_game")
    # the threaded AI move
    assert both(jgm, tgm, "start_ai_move") == (True, None)
    for gm in (jgm, tgm):
        deadline = time.time() + 60
        while gm.is_ai_thinking and time.time() < deadline:
            time.sleep(0.01)
    assert same_state(jgm, tgm)["move_count"] == 1


def test_session_board_and_device(tmp_path):
    gm = port_session("reference", str(tmp_path))
    assert all(t.device.type == "cpu" for t in gm.board)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgm_lib.GameManager(model_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgm_lib.GameManager(model_dir=str(tmp_path), device="auto")


# -- the stdlib servers ------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(base, path, method="GET", body=None, data=None):
    """(status, content type, body bytes); ``data`` is sent as is."""
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(base + path, method=method, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def api(base, path, method="GET", body=None, data=None):
    status, _, raw = http(base, path, method, body, data)
    return status, json.loads(raw)


@pytest.fixture()
def servers(monkeypatch, tmp_path):
    """The JAX and the port stdlib servers, each over its stub session."""
    jgm = jax_session(monkeypatch, "reference", str(tmp_path))
    tgm = port_session("reference", str(tmp_path))
    out = []
    for make, gm in ((jserver.make_server, jgm), (tserver.make_server, tgm)):
        port = free_port()
        server, _ = make("127.0.0.1", port, gm=gm)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out.append((server, f"http://127.0.0.1:{port}"))
    yield out[0][1], out[1][1], jgm, tgm
    for server, _ in out:
        server.shutdown()
        server.server_close()


# (method, path, JSON body or raw bytes): every route, its refusals and 404s
REST_SCRIPT = [
    ("GET", "/api/game/state", None), ("POST", "/api/game/new", None),
    ("POST", "/api/game/move", {"position": 19}), ("POST", "/api/game/move", {"position": 0}),
    ("POST", "/api/game/move", {"position": -1}), ("POST", "/api/game/move", {"position": "26"}),
    ("POST", "/api/game/move", {}), ("POST", "/api/game/move", {"position": "x"}),
    ("POST", "/api/game/move", {"position": None}), ("POST", "/api/game/move", b"{not json"),
    ("GET", "/api/game/state?x=1", None), ("POST", "/api/game/undo", None),
    ("POST", "/api/game/undo", None), ("POST", "/api/game/undo", None),
    ("GET", "/api/game/hint", None), ("POST", "/api/game/ai-move", None),
    ("GET", "/api/game/ai-status", None), ("PUT", "/api/ai/simulations", {"num_simulations": 9999}),
    ("PUT", "/api/ai/simulations", {"num_simulations": 1}),
    ("PUT", "/api/ai/simulations", {"num_simulations": "40"}),
    ("PUT", "/api/ai/simulations", {"num_simulations": "many"}), ("PUT", "/api/ai/simulations", {}),
    ("GET", "/api/ai/simulations", None), ("GET", "/api/ai/models", None),
    ("POST", "/api/ai/load-model", {}), ("GET", "/api/nope", None), ("POST", "/api/nope", None),
    ("PUT", "/api/nope", None), ("PUT", "/api/game/state", None), ("GET", "/../secrets", None),
    ("GET", "/js/../../server.py", None), ("GET", "/missing.css", None),
]


def test_rest_script_matches_jax(servers):
    jurl, turl, jgm, tgm = servers
    seen = set()
    for method, path, body in REST_SCRIPT:
        raw = body if isinstance(body, bytes) else None
        want = api(jurl, path, method, None if raw else body, raw)
        got = api(turl, path, method, None if raw else body, raw)
        assert got == want, (method, path, body)
        seen.add((method, path, got[0]))
    statuses = {s for _, _, s in seen}
    assert {200, 400, 404, 422} <= statuses
    assert ROUTES <= {(m, p) for m, p, s in seen if s not in (404, 405)}

    # then a game with the stub player on both
    install_players(jgm, tgm)
    for method, path, body in [("PUT", "/api/ai/simulations", {"num_simulations": 10}),
                               ("POST", "/api/game/new", None),
                               ("POST", "/api/game/move", {"position": 19})]:
        assert api(turl, path, method, body) == api(jurl, path, method, body)
    for _ in range(3):  # AI, then human, plies
        before = api(turl, "/api/game/state")[1]["legal_moves"]
        outs = []
        for base in (jurl, turl):
            assert api(base, "/api/game/ai-move", "POST") == (200, {"success": True, "error": None})
            for _ in range(1200):
                status, st = api(base, "/api/game/ai-status")
                if not st["is_thinking"]:
                    break
                time.sleep(0.05)
            outs.append((st, api(base, "/api/game/state")))
        assert outs[0] == outs[1]
        state = outs[1][1][1]
        assert outs[1][0]["error"] is None and state["last_ai_move"] in before
        (jh, th) = (api(base, "/api/game/hint") for base in (jurl, turl))
        assert jh[0] == th[0] == 200 and jh[1]["num_simulations"] == th[1]["num_simulations"]
        same_hint(jh[1]["evaluations"], th[1]["evaluations"])
        move = {"position": state["legal_moves"][0]}
        assert api(turl, "/api/game/move", "POST", move) == api(jurl, "/api/game/move", "POST", move)


def test_static_files_match_jax(servers):
    jurl, turl, _, _ = servers
    for path in ("/", "/index.html", "/css/style.css", "/js/api.js", "/js/board.js",
                 "/js/main.js", "/js/ui.js"):
        (js, jt, jb), (ts, tt, tb) = http(jurl, path), http(turl, path)
        assert (ts, tt) == (js, jt) == (200, tt)
        if path in ("/", "/index.html"):
            for old, new in INDEX_NAMES:
                assert new.encode() in tb
                jb = jb.replace(old.encode(), new.encode())
        assert tb == jb, path


def test_static_copy_is_the_jax_client():
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(STATIC[PORT_PKG]) == files(STATIC[JAX_PKG])
    for rel in files(STATIC[JAX_PKG]):
        with open(os.path.join(STATIC[JAX_PKG], rel)) as f:
            want = f.read()
        with open(os.path.join(STATIC[PORT_PKG], rel)) as f:
            got = f.read()
        if rel == "index.html":
            for old, new in INDEX_NAMES:
                assert want.count(old) == 1
                want = want.replace(old, new)
        assert got == want, rel


def test_client_endpoints_exist_on_port_server(servers):
    _, turl, _, tgm = servers
    bodies = {("POST", "/api/game/move"): {"position": 19},
              ("POST", "/api/ai/load-model"): {"path": "/nonexistent.pt"},
              ("PUT", "/api/ai/simulations"): {"num_simulations": 100}}
    calls = extract_fetch_calls()
    assert {(m, p) for m, p, _ in calls} == ROUTES
    api(turl, "/api/game/new", "POST")
    for method, path, keys in sorted(calls):
        body = bodies.get((method, path))
        assert tuple(sorted(body or ())) == keys
        status, data = api(turl, path, method, body)
        assert status not in (404, 405) and isinstance(data, dict), (method, path)
        if status >= 400:
            assert data.get("detail") or data.get("error")
    assert extract_state_fields() <= set(tgm.state_dict())


# -- the schemas -----------------------------------------------------------------

SCHEMA_NAMES = ["GameState", "MoveRequest", "MoveResponse", "SimpleResponse",
                "AiStatusResponse", "HintResponse", "LoadModelRequest", "SimulationsRequest",
                "SimulationsResponse", "ModelListResponse", "ErrorResponse"]


@pytest.mark.parametrize("name", SCHEMA_NAMES)
def test_schema_fields_and_defaults(name):
    port, ref = getattr(tschemas, name), getattr(jschemas, name)
    fields = {f.name: f.default for f in dataclasses.fields(port)}
    assert list(fields) == list(ref.model_fields)
    for k, f in ref.model_fields.items():
        want = PydanticUndefined if f.is_required() else f.default
        got = PydanticUndefined if fields[k] is dataclasses.MISSING else fields[k]
        assert got == want, (name, k)


def schema_samples(schemas, state: dict):
    gs = schemas.GameState(**state)
    return [gs, schemas.GameState(**{k: state[k] for k in list(state)[:7]}),
            schemas.MoveRequest(position=19), schemas.MoveResponse(success=False),
            schemas.MoveResponse(success=True, error=None, state=gs),
            schemas.SimpleResponse(success=True), schemas.SimpleResponse(success=False, error="e"),
            schemas.AiStatusResponse(is_thinking=False),
            schemas.AiStatusResponse(is_thinking=True, last_ai_move=19, error="x"),
            schemas.HintResponse(evaluations={19: 55, 64: 3}, num_simulations=10),
            schemas.HintResponse(evaluations={}, num_simulations=50),
            schemas.LoadModelRequest(path="m.pt"), schemas.SimulationsRequest(num_simulations=100),
            schemas.SimulationsResponse(num_simulations=10), schemas.ModelListResponse(models=[]),
            schemas.ModelListResponse(models=["a.pt", "b.pt"], current="a.pt"),
            schemas.ErrorResponse(detail="not found")]


def test_schema_model_dump_matches_pydantic(tmp_path):
    gm = port_session("reference", str(tmp_path))
    gm.make_move(19)
    state = gm.state_dict()
    for p, j in zip(schema_samples(tschemas, state), schema_samples(jschemas, state)):
        assert type(p).__name__ == type(j).__name__
        assert p.model_dump() == j.model_dump()
        assert json.dumps(p.model_dump()) == json.dumps(j.model_dump())


def outcome(make):
    try:
        return ("ok", make())
    except ValueError:  # pydantic's ValidationError is one
        return ("error", None)


@pytest.mark.parametrize("value", [0, 19, 64, True, 19.0, "19", " 19", 1.5, float("nan"), None,
                                   -1, -1.0, "-3", "a", "1.5", [19], {}],
                         ids=repr)
def test_request_validation_matches_pydantic(value):
    for name, field in (("MoveRequest", "position"), ("SimulationsRequest", "num_simulations"),
                        ("LoadModelRequest", "path")):
        want = outcome(lambda: getattr(getattr(jschemas, name)(**{field: value}), field))
        got = outcome(lambda: getattr(getattr(tschemas, name)(**{field: value}), field))
        assert got == want, (name, value)


# -- the FastAPI adapter -----------------------------------------------------------


class FakeHTTPException(Exception):
    def __init__(self, status_code, detail=None):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


class FakeFastAPI:
    """Records routes as FastAPI's decorators register them."""

    def __init__(self, title=""):
        self.title = title
        self.routes = {}  # (method, path) -> (handler, response_model)
        self.mounts = []

    def _register(self, method, path, response_model):
        def deco(fn):
            self.routes[(method, path)] = (fn, response_model)
            return fn

        return deco

    def get(self, path, response_model=None):
        return self._register("GET", path, response_model)

    def post(self, path, response_model=None):
        return self._register("POST", path, response_model)

    def put(self, path, response_model=None):
        return self._register("PUT", path, response_model)

    def mount(self, path, app, name=None):
        self.mounts.append((path, app))


@pytest.fixture()
def fake_fastapi(monkeypatch):
    fake = types.ModuleType("fastapi")
    fake.FastAPI = FakeFastAPI
    fake.HTTPException = FakeHTTPException
    fake.BackgroundTasks = type("BackgroundTasks", (), {})
    staticfiles = types.ModuleType("fastapi.staticfiles")
    staticfiles.StaticFiles = type("StaticFiles", (), {
        "__init__": lambda self, directory=None, html=False: setattr(self, "directory", directory)})
    fake.staticfiles = staticfiles
    monkeypatch.setitem(sys.modules, "fastapi", fake)
    monkeypatch.setitem(sys.modules, "fastapi.staticfiles", staticfiles)


def test_fastapi_adapter_routes_and_game(fake_fastapi, monkeypatch, tmp_path):
    from othello_reinforcement_learning_test_tpu.apps.web.api import create_app as jax_app
    from othello_reinforcement_learning_test_tpu_torch.apps.web.api import create_app

    jgm, gm = jax_session(monkeypatch, "reference", str(tmp_path)), port_session(
        "reference", str(tmp_path))
    app = create_app(gm=gm)
    assert set(app.routes) == set(jax_app(gm=jgm).routes) == ROUTES
    assert app.mounts[0][0] == "/" and app.mounts[0][1].directory == STATIC[PORT_PKG]

    def call(method, path, *args):
        handler, model = app.routes[(method, path)]
        out = handler(*args)
        assert isinstance(out, model)
        return out

    def refused(method, path, *args):
        with pytest.raises(FakeHTTPException) as e:
            app.routes[(method, path)][0](*args)
        return e.value.status_code, e.value.detail

    state = call("POST", "/api/game/new")
    assert state.model_dump() == gm.state_dict() and call("GET", "/api/game/state") == state
    move = call("POST", "/api/game/move", tschemas.MoveRequest(position=19))
    assert move.success and move.state.current_player == -1
    assert refused("POST", "/api/game/move", tschemas.MoveRequest(position=0)) == (
        400, "illegal move 0")
    assert call("POST", "/api/game/undo").state == state
    assert refused("POST", "/api/game/undo") == (400, "nothing to undo")
    assert refused("GET", "/api/game/hint") == (400, "no model loaded")
    assert refused("POST", "/api/game/ai-move") == (400, "no model loaded")
    assert refused("POST", "/api/ai/load-model",
                   tschemas.LoadModelRequest(path=str(tmp_path / "none.pt")))[0] == 400
    assert call("PUT", "/api/ai/simulations",
                tschemas.SimulationsRequest(num_simulations=9999)).num_simulations == 500
    assert call("GET", "/api/ai/simulations").num_simulations == 500
    assert call("GET", "/api/ai/models").model_dump() == {"models": [], "current": None}
    install_players(jgm, gm)
    assert call("POST", "/api/game/ai-move").success
    deadline = time.time() + 60
    while call("GET", "/api/game/ai-status").is_thinking and time.time() < deadline:
        time.sleep(0.01)
    status = call("GET", "/api/game/ai-status")
    assert status.last_ai_move is not None and status.error is None
    hint = call("GET", "/api/game/hint")
    assert hint.num_simulations == 10 and set(hint.evaluations) <= set(gm.legal_moves())


def test_fastapi_adapter_needs_fastapi(monkeypatch, tmp_path):
    from othello_reinforcement_learning_test_tpu_torch.apps.web.api import create_app

    monkeypatch.setitem(sys.modules, "fastapi", None)
    with pytest.raises(ImportError, match="fastapi is not installed"):
        create_app(gm=port_session("reference", str(tmp_path)))


# -- model files -------------------------------------------------------------------


def write_port_checkpoint(path: str, blocks: int = 1, filters: int = 8) -> str:
    sd = from_jax_variables(init_numpy_variables(blocks, filters, SEED))
    cfg = {"game": {"size": 8, "rules": "reference"},
           "model": {"num_blocks": blocks, "num_filters": filters}}
    return ckpt.save(path, {"model": sd, "step": 0, "iteration": 0}, cfg)


def test_list_and_load_models(tmp_path):
    port_pt = write_port_checkpoint(str(tmp_path / "run" / "checkpoint_1.pt"))
    ref_pt = str(tmp_path / "ref.pt")
    shutil.copy(REF_PT, ref_pt)

    class Scripted(torch.nn.Module):
        def forward(self, x):
            return x

    torch.jit.save(torch.jit.script(Scripted()), str(tmp_path / "scripted.pt"))
    (tmp_path / "junk.txt").write_text("not a model")
    orbax = tmp_path / "final_model"  # a JAX orbax checkpoint directory
    (orbax / "ocdbt.process_0").mkdir(parents=True)
    (orbax / "manifest.ocdbt").write_text("")
    (tmp_path / "final_model.config.json").write_text("{}")
    gm = port_session("reference", str(tmp_path))
    assert gm.list_models() == sorted([port_pt, ref_pt])
    assert os.path.exists(port_pt + ".config.json")

    ok, err = gm.load_model(str(orbax))
    assert not ok and "scripts/orbax_to_torch.py" in err and gm.last_error == err
    assert not gm.load_model(str(tmp_path / "scripted.pt"))[0]
    assert not gm.state_dict()["model_loaded"]
    gm.set_simulations(12)
    for path, arch in ((ref_pt, None), (port_pt, (1, 8))):
        assert gm.load_model(path) == (True, None)
        s = gm.state_dict()
        assert s["model_loaded"] and s["model_path"] == path
        player = gm._player
        assert player.num_simulations == 12 and player.engine is gm.engine
        assert next(player.model.parameters()).device.type == "cpu"
        if arch:
            assert (player.model.num_blocks, player.model.num_filters) == arch
        assert gm.execute_ai_move() == (True, None)
        hint = gm.hint()
        assert hint and set(hint) <= set(gm.legal_moves())


def test_ai_move_over_http_with_a_port_checkpoint(tmp_path):
    path = write_port_checkpoint(str(tmp_path / "tiny.pt"))
    port = free_port()
    server, gm = tserver.make_server("127.0.0.1", port, model_dir=str(tmp_path), device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert api(base, "/api/ai/models") == (200, {"models": [path], "current": None})
        assert api(base, "/api/ai/load-model", "POST", {"path": path}) == (
            200, {"success": True, "error": None})
        api(base, "/api/game/new", "POST")
        assert api(base, "/api/ai/simulations", "PUT", {"num_simulations": 10})[1] == {
            "num_simulations": 10}
        opening = api(base, "/api/game/state")[1]["legal_moves"]
        assert api(base, "/api/game/ai-move", "POST")[0] == 200
        for _ in range(600):
            status, st = api(base, "/api/game/ai-status")
            if not st["is_thinking"]:
                break
            time.sleep(0.05)
        assert st["error"] is None and st["last_ai_move"] in opening
        state = api(base, "/api/game/state")[1]
        assert state["move_count"] == 1 and state["model_path"] == path
        status, hint = api(base, "/api/game/hint")
        assert status == 200 and set(map(int, hint["evaluations"])) <= set(state["legal_moves"])
    finally:
        server.shutdown()
        server.server_close()


# -- the entry points --------------------------------------------------------------


def option_table(parser: argparse.ArgumentParser) -> list:
    return sorted((tuple(a.option_strings), a.dest, repr(a.default), repr(a.choices),
                   repr(a.nargs), repr(a.const), repr(a.type), a.required, type(a).__name__)
                  for a in parser._actions)


class _Parsed(Exception):
    pass


def jax_script_parser(monkeypatch, script: str) -> argparse.ArgumentParser:
    """The parser a root script builds in its ``main()``, caught at
    ``parse_args`` (the scripts build it inline)."""
    def stop(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    spec = importlib.util.spec_from_file_location(f"root_{script}", os.path.join(REPO, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(_Parsed) as e:
        mod.main()
    return e.value.args[0]


@pytest.mark.parametrize("script", ["run_web", "run_gui", "demo_gui"])
def test_entry_point_parsers_match_the_root_scripts(script, monkeypatch):
    port = importlib.import_module(f"{PORT_PKG}.{script}").build_parser()
    assert option_table(port) == option_table(jax_script_parser(monkeypatch, f"{script}.py"))


def test_entry_points_need_cuda_unless_cpu(tmp_path):
    for main in (run_web.main, run_gui.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--model-dir", str(tmp_path)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--device", "auto", "--model-dir", str(tmp_path)])
    # --asgi needs uvicorn, as the root script does
    with pytest.raises(ModuleNotFoundError, match="uvicorn"):
        run_web.main(["--device", "cpu", "--asgi", "--model-dir", str(tmp_path)])


def test_run_web_serves_the_client_on_the_cpu(tmp_path):
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT_PKG}.run_web", "--device", "cpu", "--port", str(port),
         "--model-dir", str(tmp_path), "--simulations", "20"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        while not (lines and lines[-1].startswith("serving on")) and len(lines) < 50:
            lines.append(proc.stdout.readline())
            assert lines[-1], "".join(lines)  # EOF: the server exited
        assert lines[-1].strip() == f"serving on http://127.0.0.1:{port}", lines
        base = f"http://127.0.0.1:{port}"
        status, ctype, body = http(base, "/")
        assert status == 200 and ctype.startswith("text/html") and b"PyTorch/H100" in body
        assert api(base, "/api/ai/simulations") == (200, {"num_simulations": 20})
        assert api(base, "/api/game/move", "POST", {"position": 19})[1]["success"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
