"""The web API's request and response models, as dataclasses.

Port of ``othello_reinforcement_learning_test_tpu/apps/web/schemas.py``,
whose 11 models are pydantic's; the card's machine has no pydantic. Each
model here has the same fields, order and defaults, and ``model_dump()``
gives the dict the pydantic model gives (a nested ``GameState`` as a dict).

The three request models check their fields as the pydantic models do and
raise ``ValueError``, which the FastAPI adapter answers with 422: an
integer field takes an int, a bool, an integral float or a string holding
an integer (pydantic's lax mode), ``MoveRequest.position`` must be >= 0,
and ``LoadModelRequest.path`` must be a string. The response models are
built from the session's own values and are not checked.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


class _Model:
    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _integer(name: str, value: Any) -> int:
    if isinstance(value, int):  # bool included, as in pydantic's lax mode
        return int(value)
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
    raise ValueError(f"{name}: input should be a valid integer, got {value!r}")


@dataclass
class GameState(_Model):
    board: List[List[int]]
    current_player: int
    legal_moves: List[int]
    black_count: int
    white_count: int
    move_count: int
    is_game_over: bool
    winner: Optional[int] = None
    last_move: Optional[int] = None
    last_ai_move: Optional[int] = None
    is_ai_thinking: bool = False
    model_loaded: bool = False
    model_path: Optional[str] = None
    ai_simulations: int = 100
    can_undo: bool = False
    board_size: int = 8


@dataclass
class MoveRequest(_Model):
    position: int

    def __post_init__(self):
        self.position = _integer("position", self.position)
        if self.position < 0:
            raise ValueError(f"position: input should be >= 0, got {self.position}")


@dataclass
class MoveResponse(_Model):
    success: bool
    error: Optional[str] = None
    state: Optional[GameState] = None


@dataclass
class SimpleResponse(_Model):
    success: bool
    error: Optional[str] = None


@dataclass
class AiStatusResponse(_Model):
    is_thinking: bool
    last_ai_move: Optional[int] = None
    error: Optional[str] = None


@dataclass
class HintResponse(_Model):
    evaluations: Dict[int, int]
    num_simulations: int


@dataclass
class LoadModelRequest(_Model):
    path: str

    def __post_init__(self):
        if not isinstance(self.path, str):
            raise ValueError(f"path: input should be a valid string, got {self.path!r}")


@dataclass
class SimulationsRequest(_Model):
    num_simulations: int

    def __post_init__(self):
        self.num_simulations = _integer("num_simulations", self.num_simulations)


@dataclass
class SimulationsResponse(_Model):
    num_simulations: int


@dataclass
class ModelListResponse(_Model):
    models: List[str]
    current: Optional[str] = None


@dataclass
class ErrorResponse(_Model):
    detail: str
