"""Optional FastAPI adapter exposing the same REST surface as
:mod:`.server`, over the port's schemas (dataclasses; FastAPI takes them as
request and response models).

Port of ``othello_reinforcement_learning_test_tpu/apps/web/api.py``. The
import is gated: ``create_app()`` raises a clear error when FastAPI is
missing; the stdlib server (:mod:`.server`) is the default transport.
"""

from __future__ import annotations

from typing import Optional

from . import schemas
from .game_manager import GameManager


def create_app(gm: Optional[GameManager] = None, model_dir: str = "data/models",
               device=None):
    try:
        from fastapi import FastAPI, HTTPException
        from fastapi.staticfiles import StaticFiles
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "fastapi is not installed; use apps.web.server (stdlib) instead"
        ) from e

    import os

    gm = gm or GameManager(model_dir=model_dir, device=device)
    app = FastAPI(title="Othello AlphaZero (PyTorch/H100)")

    def state() -> schemas.GameState:
        return schemas.GameState(**gm.state_dict())

    @app.post("/api/game/new", response_model=schemas.GameState)
    def new_game():
        ok, err = gm.new_game()
        if not ok:
            raise HTTPException(409, err)
        return state()

    @app.get("/api/game/state", response_model=schemas.GameState)
    def game_state():
        return state()

    @app.post("/api/game/move", response_model=schemas.MoveResponse)
    def move(req: schemas.MoveRequest):
        ok, err = gm.make_move(req.position)
        if not ok:
            raise HTTPException(400, err)
        return schemas.MoveResponse(success=True, state=state())

    @app.post("/api/game/undo", response_model=schemas.MoveResponse)
    def undo():
        ok, err = gm.undo()
        if not ok:
            raise HTTPException(400, err)
        return schemas.MoveResponse(success=True, state=state())

    @app.post("/api/game/ai-move", response_model=schemas.SimpleResponse)
    def ai_move():
        ok, err = gm.start_ai_move()
        if not ok:
            raise HTTPException(400, err)
        return schemas.SimpleResponse(success=True)

    @app.get("/api/game/ai-status", response_model=schemas.AiStatusResponse)
    def ai_status():
        return schemas.AiStatusResponse(
            is_thinking=gm.is_ai_thinking,
            last_ai_move=gm.last_ai_move,
            error=gm.last_error,
        )

    @app.get("/api/game/hint", response_model=schemas.HintResponse)
    def hint():
        if not gm.state_dict()["model_loaded"]:
            raise HTTPException(400, "no model loaded")
        return schemas.HintResponse(
            evaluations=gm.hint(),
            num_simulations=max(10, gm.ai_simulations // 2),
        )

    @app.post("/api/ai/load-model", response_model=schemas.SimpleResponse)
    def load_model(req: schemas.LoadModelRequest):
        ok, err = gm.load_model(req.path)
        if not ok:
            raise HTTPException(400, err)
        return schemas.SimpleResponse(success=True)

    @app.put("/api/ai/simulations", response_model=schemas.SimulationsResponse)
    def set_simulations(req: schemas.SimulationsRequest):
        return schemas.SimulationsResponse(
            num_simulations=gm.set_simulations(req.num_simulations)
        )

    @app.get("/api/ai/simulations", response_model=schemas.SimulationsResponse)
    def get_simulations():
        return schemas.SimulationsResponse(num_simulations=gm.ai_simulations)

    @app.get("/api/ai/models", response_model=schemas.ModelListResponse)
    def list_models():
        return schemas.ModelListResponse(models=gm.list_models(),
                                         current=gm.model_path)

    static_dir = os.path.join(os.path.dirname(__file__), "static")
    app.mount("/", StaticFiles(directory=static_dir, html=True), name="static")
    return app
