"""Headless game-session manager shared by the web and GUI front-ends.

Port of ``othello_reinforcement_learning_test_tpu/apps/web/game_manager.py``:
one interactive game session with history and undo, threaded AI moves with
an illegal-action random fallback, hint evaluations, model loading and a
simulations knob clamped to [10, 500]. The board lives in the port's
batched engine with batch (1,) on ``device`` (CUDA unless ``"cpu"`` is
asked for; no fallback); AI moves and hints run the port's MCTS there.

The state views read the board back to the host once and compute on the
CPU copy with the same engine, so a ``state_dict()`` costs one copy from
the card rather than one synchronisation per field.

Two stated differences from the JAX session: models are ``.pt`` files (the
port's checkpoints and reference-format files), so ``list_models`` lists no
orbax directory and ``load_model`` refuses a directory, naming the
converter ``scripts/orbax_to_torch.py``.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...ops import bits
from ...ops.bitboard import Board, OthelloEngine, get_engine
from ...search import mcts
from ...utils.device import resolve_device

MIN_SIMULATIONS = 10
MAX_SIMULATIONS = 500


def _is_state_dict_file(path: str) -> bool:
    """True for torch pickle checkpoints (``torch.save`` zip archives hold a
    ``data.pkl``), False for TorchScript exports (``torch.jit.save`` archives
    hold ``constants.pkl`` and a ``code/`` tree as well), which fail under
    ``torch.load(weights_only=True)``, so listing them would offer a dead
    entry. Legacy non-zip pickles pass through as loadable."""
    import zipfile

    try:
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
        return not any(n.endswith("constants.pkl") or "/code/" in n for n in names)
    except zipfile.BadZipFile:
        return True
    except OSError:
        return False


class GameManager:
    """Single interactive game session (thread-safe via a session lock)."""

    def __init__(self, engine: Optional[OthelloEngine] = None,
                 model_dir: str = "data/models", device=None):
        self.device = resolve_device(device)
        self.engine = engine or get_engine(8, "reference")
        self.model_dir = model_dir
        self._lock = threading.RLock()
        self._player = None  # MCTSPlayer once a model is loaded
        self.model_path: Optional[str] = None
        self.ai_simulations = 100
        self.is_ai_thinking = False
        self.last_ai_move: Optional[int] = None
        self.last_error: Optional[str] = None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(time.time()) & 0x7FFFFFFF)
        self.new_game()

    # -- session -----------------------------------------------------------
    def new_game(self) -> Tuple[bool, Optional[str]]:
        """Reset the session; refused while the AI thread is running so a
        stale background move can't land on the fresh board."""
        with self._lock:
            if getattr(self, "is_ai_thinking", False):
                return False, "AI is thinking"
            self.board = self.engine.initial_state((1,), device=self.device)
            self.history: List[Board] = []
            self.last_move: Optional[int] = None
            self.last_ai_move = None
            self.last_error = None
            return True, None

    def _action(self, action: int) -> torch.Tensor:
        return torch.tensor([action], dtype=torch.int64, device=self.device)

    def _host_board(self) -> Board:
        return Board(*(t.cpu() for t in self.board))

    # -- state views (on a host copy of the board) ---------------------------
    def _board_array(self, board: Board) -> List[List[int]]:
        s = self.engine.size
        me = bits.to_planes(board.me, torch.int32)[0].tolist()
        opp = bits.to_planes(board.opp, torch.int32)[0].tolist()
        black, white = (me, opp) if self._current_player(board) == 1 else (opp, me)
        # square (r, c) is bit r * 8 + c at every size
        return [[1 if black[r * 8 + c] else (-1 if white[r * 8 + c] else 0)
                 for c in range(s)] for r in range(s)]

    @staticmethod
    def _current_player(board: Board) -> int:
        return 1 if int(board.move_count[0]) % 2 == 0 else -1

    def _legal_moves(self, board: Board) -> List[int]:
        return torch.nonzero(self.engine.legal_actions(board)[0]).flatten().tolist()

    def _stone_counts(self, board: Board) -> Tuple[int, int]:
        c_me, c_opp = (int(c[0]) for c in self.engine.stone_counts(board))
        return (c_me, c_opp) if self._current_player(board) == 1 else (c_opp, c_me)

    def _is_game_over(self, board: Board) -> bool:
        return bool(self.engine.is_terminal(board)[0])

    def _winner(self, board: Board) -> Optional[int]:
        if not self._is_game_over(board):
            return None
        w = int(self.engine.winner(board)[0])
        return w * self._current_player(board)

    def board_array(self) -> List[List[int]]:
        """SxS ints: 0 empty, +1 black, -1 white. Black is the parity-0
        mover."""
        return self._board_array(self._host_board())

    def current_player(self) -> int:
        """+1 black to move, -1 white."""
        return self._current_player(self._host_board())

    def legal_moves(self) -> List[int]:
        return self._legal_moves(self._host_board())

    def stone_counts(self) -> Tuple[int, int]:
        """(black, white)."""
        return self._stone_counts(self._host_board())

    def is_game_over(self) -> bool:
        return self._is_game_over(self._host_board())

    def winner(self) -> Optional[int]:
        """+1 black, -1 white, 0 draw, None if running."""
        return self._winner(self._host_board())

    def state_dict(self) -> Dict:
        board = self._host_board()
        black, white = self._stone_counts(board)
        return {
            "board": self._board_array(board),
            "current_player": self._current_player(board),
            "legal_moves": self._legal_moves(board),
            "black_count": black,
            "white_count": white,
            "move_count": int(board.move_count[0]),
            "is_game_over": self._is_game_over(board),
            "winner": self._winner(board),
            "last_move": self.last_move,
            "last_ai_move": self.last_ai_move,
            "is_ai_thinking": self.is_ai_thinking,
            "model_loaded": self._player is not None,
            "model_path": self.model_path,
            "ai_simulations": self.ai_simulations,
            "can_undo": len(self.history) > 0,
            "board_size": self.engine.size,
        }

    # -- moves -------------------------------------------------------------
    def make_move(self, action: int) -> Tuple[bool, Optional[str]]:
        with self._lock:
            if self.is_ai_thinking:
                return False, "AI is thinking"
            if self.is_game_over():
                return False, "game is over"
            if action not in self.legal_moves():
                return False, f"illegal move {action}"
            self.history.append(self.board)
            self.board, ok = self.engine.step(self.board, self._action(action))
            self.last_move = int(action)
            return bool(ok[0]), None

    def undo(self) -> Tuple[bool, Optional[str]]:
        """Pop one ply."""
        with self._lock:
            if self.is_ai_thinking:
                return False, "AI is thinking"
            if not self.history:
                return False, "nothing to undo"
            self.board = self.history.pop()
            self.last_move = None
            return True, None

    # -- AI ----------------------------------------------------------------
    def load_model(self, path: str) -> Tuple[bool, Optional[str]]:
        """Load a ``.pt`` file (a port checkpoint or a reference-format
        file) as an MCTS player on the session's device."""
        from ...evaluation.players import MCTSPlayer

        with self._lock:
            if self.is_ai_thinking:
                return False, "AI is thinking"
        try:
            if os.path.isdir(path):
                raise ValueError(
                    f"{path} is a directory: the PyTorch port loads .pt files; convert "
                    "a JAX orbax checkpoint with scripts/orbax_to_torch.py")
            player = MCTSPlayer.from_checkpoint(
                path, engine=self.engine, num_simulations=self.ai_simulations,
                device=self.device)
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            self.last_error = str(e)
            return False, str(e)
        with self._lock:
            self._player = player
            self.model_path = path
        return True, None

    def set_simulations(self, n: int) -> int:
        n = max(MIN_SIMULATIONS, min(MAX_SIMULATIONS, int(n)))
        with self._lock:
            self.ai_simulations = n
            if self._player is not None:
                self._player.num_simulations = n
        return n

    def list_models(self) -> List[str]:
        """The ``.pt``/``.pth`` files under the model dir that ``load_model``
        can read: the port's checkpoints and reference-format files, not
        TorchScript exports (nor the checkpoints' JSON sidecars)."""
        return [p for p in sorted(glob.glob(os.path.join(self.model_dir, "**"), recursive=True))
                if os.path.isfile(p) and p.endswith((".pt", ".pth")) and _is_state_dict_file(p)]

    def execute_ai_move(self) -> Tuple[bool, Optional[str]]:
        """Synchronous AI move (callers may thread it), with the
        illegal-action fallback to a random legal move."""
        with self._lock:
            if self._player is None:
                return False, "no model loaded"
            if self.is_ai_thinking:
                return False, "AI is already thinking"
            if self.is_game_over():
                return False, "game is over"
            self.is_ai_thinking = True
        return self._compute_ai_move()

    def _compute_ai_move(self) -> Tuple[bool, Optional[str]]:
        """Assumes ``is_ai_thinking`` is already set; clears it when done."""
        self.last_error = None  # a new attempt clears stale errors
        try:
            action = int(self._player.act(self.board, self._generator)[0])
            legal = self.legal_moves()
            if action not in legal:
                action = int(np.random.default_rng().choice(legal))
            with self._lock:
                self.history.append(self.board)
                self.board, _ = self.engine.step(self.board, self._action(action))
                self.last_move = action
                self.last_ai_move = action
            return True, None
        except Exception as e:  # noqa: BLE001
            self.last_error = str(e)
            return False, str(e)
        finally:
            self.is_ai_thinking = False

    def start_ai_move(self) -> Tuple[bool, Optional[str]]:
        """Async AI move: background thread + ``is_ai_thinking`` polling."""
        with self._lock:
            if self._player is None:
                return False, "no model loaded"
            if self.is_ai_thinking:
                return False, "AI is already thinking"
            if self.is_game_over():
                return False, "game is over"
            self.is_ai_thinking = True

        threading.Thread(target=self._compute_ai_move, daemon=True).start()
        return True, None

    def hint(self) -> Dict[int, int]:
        """{action: 0-100 eval} for legal moves, from a search at
        max(10, sims // 2) simulations without root noise. Snapshots the
        board under the lock so a concurrent AI move can't produce
        evaluations for a different position."""
        with self._lock:
            if self._player is None or self.is_ai_thinking:
                return {}
            board = self.board
        sims = max(10, self.ai_simulations // 2)
        with torch.no_grad():  # thread-local; the hint may run on any thread
            res = mcts.search(self.engine, self._player.net, board, sims, add_noise=False,
                              generator=self._generator)
        ev = mcts.action_evaluations(res)[0].cpu()
        legal = torch.nonzero(res.legal[0].cpu()).flatten().tolist()
        return {a: int(ev[a]) for a in legal if ev[a] >= 0}
