"""Dependency-free HTTP server for the web app.

Port of ``othello_reinforcement_learning_test_tpu/apps/web/server.py``: the
same REST surface, status codes, JSON bodies and static serving (with its
path-traversal guard) on the stdlib ``ThreadingHTTPServer``, over the port's
:class:`GameManager`; :mod:`.api` exposes the same routes as an ASGI app
where FastAPI is installed.

Endpoints (all JSON):
  POST /api/game/new          -> GameState
  GET  /api/game/state        -> GameState
  POST /api/game/move         {position} -> MoveResponse
  POST /api/game/undo         -> MoveResponse
  POST /api/game/ai-move      -> SimpleResponse (async; poll ai-status)
  GET  /api/game/ai-status    -> AiStatusResponse
  GET  /api/game/hint         -> HintResponse
  POST /api/ai/load-model     {path} -> SimpleResponse
  PUT  /api/ai/simulations    {num_simulations} -> SimulationsResponse
  GET  /api/ai/simulations    -> SimulationsResponse
  GET  /api/ai/models         -> ModelListResponse
Static files are served from ``static/`` at ``/``.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import schemas
from .game_manager import GameManager

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")

_CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".js": "application/javascript; charset=utf-8",
    ".json": "application/json",
    ".png": "image/png",
    ".svg": "image/svg+xml",
    ".ico": "image/x-icon",
}


def _game_state(gm: GameManager) -> schemas.GameState:
    return schemas.GameState(**gm.state_dict())


class OthelloRequestHandler(BaseHTTPRequestHandler):
    """Routes requests to the shared :class:`GameManager` singleton."""

    gm: GameManager = None  # injected by make_server
    protocol_version = "HTTP/1.1"

    # -- helpers -----------------------------------------------------------
    def _send_json(self, payload, status: int = 200) -> None:
        if hasattr(payload, "model_dump"):
            payload = payload.model_dump()
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, detail: str, status: int = 400) -> None:
        self._send_json({"detail": detail}, status)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return {}
        try:
            return json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return {}

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -- static ------------------------------------------------------------
    def _serve_static(self, path: str) -> None:
        if path in ("/", ""):
            path = "/index.html"
        static_root = os.path.abspath(STATIC_DIR)
        fs_path = os.path.abspath(
            os.path.normpath(os.path.join(static_root, path.lstrip("/")))
        )
        if os.path.commonpath([fs_path, static_root]) != static_root:
            return self._error("not found", 404)
        if not os.path.isfile(fs_path):
            return self._error("not found", 404)
        ext = os.path.splitext(fs_path)[1]
        with open(fs_path, "rb") as f:
            body = f.read()
        self.send_response(200)
        self.send_header("Content-Type", _CONTENT_TYPES.get(ext, "application/octet-stream"))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- routing ------------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        gm = self.gm
        path = self.path.split("?")[0]
        if path == "/api/game/state":
            self._send_json(_game_state(gm))
        elif path == "/api/game/ai-status":
            self._send_json(
                schemas.AiStatusResponse(
                    is_thinking=gm.is_ai_thinking,
                    last_ai_move=gm.last_ai_move,
                    error=gm.last_error,
                )
            )
        elif path == "/api/game/hint":
            if not gm.state_dict()["model_loaded"]:
                return self._error("no model loaded", 400)
            evals = gm.hint()
            self._send_json(
                schemas.HintResponse(
                    evaluations=evals,
                    num_simulations=max(10, gm.ai_simulations // 2),
                )
            )
        elif path == "/api/ai/simulations":
            self._send_json(
                schemas.SimulationsResponse(num_simulations=gm.ai_simulations)
            )
        elif path == "/api/ai/models":
            self._send_json(
                schemas.ModelListResponse(models=gm.list_models(),
                                          current=gm.model_path)
            )
        elif path.startswith("/api/"):
            self._error("not found", 404)
        else:
            self._serve_static(path)

    def do_POST(self) -> None:  # noqa: N802
        gm = self.gm
        path = self.path.split("?")[0]
        body = self._read_body()
        if path == "/api/game/new":
            ok, err = gm.new_game()
            if not ok:
                return self._error(err, 409)
            self._send_json(_game_state(gm))
        elif path == "/api/game/move":
            if "position" not in body:
                return self._error("position required", 422)
            try:
                position = int(body["position"])
            except (TypeError, ValueError):
                return self._error("position must be an integer", 422)
            ok, err = gm.make_move(position)
            self._send_json(
                schemas.MoveResponse(
                    success=ok, error=err, state=_game_state(gm)
                ),
                200 if ok else 400,
            )
        elif path == "/api/game/undo":
            ok, err = gm.undo()
            self._send_json(
                schemas.MoveResponse(success=ok, error=err, state=_game_state(gm)),
                200 if ok else 400,
            )
        elif path == "/api/game/ai-move":
            ok, err = gm.start_ai_move()
            self._send_json(schemas.SimpleResponse(success=ok, error=err),
                            200 if ok else 400)
        elif path == "/api/ai/load-model":
            if "path" not in body:
                return self._error("path required", 422)
            ok, err = gm.load_model(body["path"])
            self._send_json(schemas.SimpleResponse(success=ok, error=err),
                            200 if ok else 400)
        else:
            self._error("not found", 404)

    def do_PUT(self) -> None:  # noqa: N802
        gm = self.gm
        path = self.path.split("?")[0]
        body = self._read_body()
        if path == "/api/ai/simulations":
            if "num_simulations" not in body:
                return self._error("num_simulations required", 422)
            try:
                n = gm.set_simulations(int(body["num_simulations"]))
            except (TypeError, ValueError):
                return self._error("num_simulations must be an integer", 422)
            self._send_json(schemas.SimulationsResponse(num_simulations=n))
        else:
            self._error("not found", 404)


def make_server(
    host: str = "127.0.0.1",
    port: int = 8000,
    gm: Optional[GameManager] = None,
    model_dir: str = "data/models",
    device=None,
) -> Tuple[ThreadingHTTPServer, GameManager]:
    """The server and its session; ``device`` is the new session's (CUDA
    unless ``"cpu"`` is asked for) when no ``gm`` is given."""
    gm = gm or GameManager(model_dir=model_dir, device=device)
    handler = type("Handler", (OthelloRequestHandler,), {"gm": gm})
    server = ThreadingHTTPServer((host, port), handler)
    return server, gm


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
