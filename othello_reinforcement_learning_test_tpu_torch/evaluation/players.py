"""Players: batched policies over batched boards.

Port of ``othello_reinforcement_learning_test_tpu/evaluation/players.py``.
A player maps a whole batch of boards to a batch of actions, so an arena
runs all its games in lockstep. ``act(boards, generator, rows)`` takes the
generator that draws any randomness (on the boards' device) and returns
``(B,) int64`` actions on the boards' device; ``rows``, when given, says
that the boards are those rows of a global batch (a rank's share of a
sharded match), and a player that draws takes its draws at the global
shape, so that every rank draws as the unsharded match does.

The JAX package's ``stateless()`` (one jitted match program per pair of
player types) has no counterpart: PyTorch runs eagerly. Its host-side
players (Edax, the native alpha-beta engine) run behind ``io_callback``;
here they are plain host calls on the boards.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..models.torch_bridge import infer_architecture
from ..ops import bits
from ..ops.bitboard import Board, OthelloEngine, get_engine
from ..parallel.mesh import Rows
from ..search import mcts
from ..train.self_play import _sample


class Player:
    """Batched policy: ``act(boards, generator) -> (B,) int64 actions``."""

    name = "player"

    def act(self, boards: Board, generator: Optional[torch.Generator] = None,
            rows: Optional[Rows] = None) -> torch.Tensor:
        raise NotImplementedError

    def reset(self) -> None:
        """Session hook: a new game or match starts."""


def uniform_legal(engine: OthelloEngine, boards: Board, generator: torch.Generator,
                  rows: Optional[Rows] = None) -> torch.Tensor:
    """One action per board, uniform over its legal actions, drawn from
    ``generator`` as self-play samples its moves (at the global shape with
    ``rows``)."""
    return _sample(engine.legal_actions(boards).to(torch.float32), generator, rows)


class RandomPlayer(Player):
    """Uniform over legal actions."""

    name = "Random"

    def __init__(self, engine: OthelloEngine):
        self.engine = engine

    def act(self, boards: Board, generator: Optional[torch.Generator] = None,
            rows: Optional[Rows] = None) -> torch.Tensor:
        return uniform_legal(self.engine, boards, generator, rows)


class GreedyPlayer(Player):
    """Maximizes its own stone count after the move: the mover's stones after
    playing square ``a`` number popcount(me) + 1 + popcount(flips), so the
    flips of every square are counted at once. Ties go to the lowest action
    index; with no legal square the player passes."""

    name = "Greedy"

    def __init__(self, engine: OthelloEngine):
        self.engine = engine

    def act(self, boards: Board, generator: Optional[torch.Generator] = None,
            rows: Optional[Rows] = None) -> torch.Tensor:
        eng = self.engine
        legal = eng.legal_actions(boards)
        n_sq = eng.pass_action
        squares = torch.arange(n_sq, device=legal.device)
        moves = bits.bit(eng.action_to_bitpos(squares)).expand(*boards.me.shape, n_sq)
        f = eng.flips(boards.me[..., None].expand_as(moves),
                      boards.opp[..., None].expand_as(moves), moves)
        gains = torch.where(legal[..., :n_sq], bits.popcount(f) + 1, -1)
        best = torch.argmax(gains, dim=-1)  # the first of equal maxima
        return torch.where(legal[..., n_sq], n_sq, best)


class MCTSPlayer(Player):
    """A network and MCTS at temperature 0 with no root noise: ``search``,
    then the most visited legal action. ``net`` maps (B, S, S, 3) features
    to ``(log_probs, value)`` on the boards' device."""

    name = "MCTS"

    def __init__(self, engine: OthelloEngine, net: mcts.Net, num_simulations: int = 50,
                 c_puct: float = 1.0):
        self.engine = engine
        self.net = net
        self.num_simulations = num_simulations
        self.c_puct = c_puct

    @torch.no_grad()
    def act(self, boards: Board, generator: Optional[torch.Generator] = None,
            rows: Optional[Rows] = None) -> torch.Tensor:
        res = mcts.search(self.engine, self.net, boards, self.num_simulations,
                          c_puct=self.c_puct, add_noise=False)
        return mcts.best_action(res.visit_counts, res.legal)

    @classmethod
    def from_checkpoint(cls, path: str, engine: Optional[OthelloEngine] = None,
                        num_simulations: int = 50, c_puct: float = 1.0,
                        device=None) -> "MCTSPlayer":
        """Load a ``.pt`` file, telling the two formats apart by content:

        - the port's own checkpoints (``train/checkpoint.py``, either
          format): the architecture comes from the config sidecar (or the
          config saved in the file), as in the JAX package;
        - reference-format files (a dict with ``model_state_dict``, or a
          bare state dict): the architecture comes from the state dict's
          shapes, and the file's config rides along.

        The network plays through the plain bf16 eval forward on ``device``
        (CUDA unless ``"cpu"`` is asked for)."""
        from ..models.resnet import OthelloResNet
        from ..train import checkpoint as ckpt_lib
        from ..train.trainer import apply_eval
        from ..utils.device import resolve_device

        dev = resolve_device(device)
        obj = ckpt_lib.load(path)
        if not isinstance(obj, dict):
            raise ValueError(f"{path}: not a checkpoint (a {type(obj).__name__})")
        train_state = None
        if "train_state" in obj or {"model", "step", "iteration"} <= obj.keys():
            train_state = obj.get("train_state", obj)
            sd = train_state["model"]
            cfg = ckpt_lib.load_config(path) or obj.get("config") or {}
            mc = cfg.get("model", {})
            size = int(cfg.get("game", {}).get("size", mc.get("board_size", 8)))
            arch = (int(mc.get("num_blocks", 10)), int(mc.get("num_filters", 128)), size,
                    int(mc.get("value_hidden", 256)))
        elif "model_state_dict" in obj or "conv_block.conv.weight" in obj:
            sd = obj.get("model_state_dict", obj)
            cfg = (obj.get("config") or {}) if "model_state_dict" in obj else {}
            arch = infer_architecture(sd)
        else:
            raise ValueError(f"{path}: neither a port checkpoint nor a reference-format "
                             f"state dict (keys {sorted(obj)[:6]})")
        model = OthelloResNet(*arch)
        model.load_state_dict(sd)
        model = model.to(dev).eval()
        engine = engine or get_engine(model.board_size,
                                      cfg.get("game", {}).get("rules", "reference"))
        player = cls(engine, apply_eval(model), num_simulations=num_simulations,
                     c_puct=c_puct)
        player.model = model
        player.config = cfg
        if train_state is not None:
            player.train_state = train_state
        return player


class _HostPlayer(Player):
    """Players whose move choice runs on the host, one game at a time:
    games with no legal square pass without asking (finished games in the
    lockstep arena never reach the engine), and a reply that is ``None``, a
    pass or illegal falls back to the first legal action.

    Subclasses implement ``_host_move(i, me_words, opp_words, move_count,
    legal) -> Optional[int]`` for game ``i``; the words are uint64."""

    engine: OthelloEngine

    def _host_move(self, i: int, me_words: np.ndarray, opp_words: np.ndarray,
                   move_count: np.ndarray, legal: np.ndarray) -> Optional[int]:
        raise NotImplementedError

    def _host_act(self, me_words: np.ndarray, opp_words: np.ndarray, move_count: np.ndarray,
                  legal: np.ndarray) -> np.ndarray:
        pass_action = self.engine.pass_action
        actions = np.zeros((me_words.shape[0],), np.int64)
        for i in range(me_words.shape[0]):
            if not legal[i, :pass_action].any():
                actions[i] = pass_action  # pass-only or finished game
                continue
            a = self._host_move(i, me_words, opp_words, move_count, legal)
            if a is None or a >= pass_action or not legal[i, a]:
                a = int(np.argmax(legal[i]))  # stay legal
            actions[i] = a
        return actions

    def act(self, boards: Board, generator: Optional[torch.Generator] = None,
            rows: Optional[Rows] = None) -> torch.Tensor:
        legal = self.engine.legal_actions(boards).cpu().numpy()
        actions = self._host_act(boards.me.cpu().numpy().view(np.uint64),
                                 boards.opp.cpu().numpy().view(np.uint64),
                                 boards.move_count.cpu().numpy(), legal)
        return torch.from_numpy(actions).to(boards.me.device)


class EdaxPlayer(_HostPlayer):
    """External Edax engine over a persistent console subprocess.

    The wire protocol (Edax console, one command per line):

    - ``setboard <cells> <turn>``: ``cells`` is S*S characters row-major
      from a1, ``X`` black, ``O`` white, ``-`` empty; ``turn`` is ``X`` or
      ``O``;
    - ``go``: the engine answers a line matching ``Edax plays <MOVE>``,
      MOVE a coordinate like ``D3`` (column letter, 1-based row) or ``PS``
      for a pass;
    - ``quit``.

    ``binary_path`` (or ``$EDAX_BINARY``, or ``edax`` on ``PATH``) selects
    the engine; without one the player plays uniformly at random and its
    name says so. ``args`` (or ``$EDAX_ARGS``, shlex-split; default ``-q
    -level N``) replaces the argument vector, and ``reply_pattern`` (or
    ``$EDAX_REPLY_PATTERN``) the reply regex, whose group 1 captures the
    move; the default accepts ``Edax plays D3``, ``move d3``, ``bestmove
    D3`` and ``PS``/``pass``. A reply is awaited at most
    ``REPLY_TIMEOUT_S`` seconds; an illegal, late or unparseable one falls
    back to the first legal action.
    """

    DEFAULT_REPLY_PATTERN = r"(?:plays|moves?|bestmove)\s+([A-Ha-h][1-8]|PS|pass)"
    REPLY_TIMEOUT_S = 5.0

    def __init__(self, engine: OthelloEngine, binary_path: Optional[str] = None,
                 level: int = 5, args: Optional[list] = None,
                 reply_pattern: Optional[str] = None):
        import re
        import shlex
        import shutil

        self.engine = engine
        self.level = int(level)
        self.binary = binary_path or os.environ.get("EDAX_BINARY") or shutil.which("edax")
        if args is None:
            env_args = os.environ.get("EDAX_ARGS")
            args = shlex.split(env_args) if env_args else ["-q", "-level", str(self.level)]
        elif isinstance(args, str):
            args = shlex.split(args)
        self.args = list(args)
        self._move_re = re.compile(
            reply_pattern or os.environ.get("EDAX_REPLY_PATTERN") or self.DEFAULT_REPLY_PATTERN,
            re.IGNORECASE)
        self._proc = None
        if self.binary and os.path.exists(self.binary):
            self.name = f"Edax(L{self.level})"
            self._fallback = None
        else:
            self.binary = None
            self.name = "Edax(random-fallback)"
            self._fallback = RandomPlayer(engine)

    def _ensure_proc(self):
        import queue
        import subprocess
        import threading

        if self._proc is not None and self._proc.poll() is None:
            return self._proc
        self._proc = subprocess.Popen([self.binary, *self.args], stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                      text=True, bufsize=1)
        # readline() on a pipe has no timeout, so a reader thread feeds a
        # queue that is polled with a deadline: an engine that stops
        # answering cannot hang the match
        self._lines = queue.Queue()

        def pump(proc, q):
            for line in proc.stdout:
                q.put(line)
            q.put(None)  # end of output

        threading.Thread(target=pump, args=(self._proc, self._lines), daemon=True).start()
        return self._proc

    def _readline(self) -> Optional[str]:
        """The next output line, or None at the end of output or timeout."""
        import queue

        try:
            return self._lines.get(timeout=self.REPLY_TIMEOUT_S)
        except queue.Empty:
            return None

    def close(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.stdin.write("quit\n")
                self._proc.stdin.flush()
                self._proc.wait(timeout=2)
            except Exception:  # noqa: BLE001 — a stuck engine is killed
                self._proc.kill()
        self._proc = None

    reset = close  # a new session starts a fresh engine

    def _query_move(self, cells: str, turn: str) -> Optional[int]:
        """One setboard/go round trip -> action index, or None on failure."""
        try:
            proc = self._ensure_proc()
            proc.stdin.write(f"setboard {cells} {turn}\ngo\n")
            proc.stdin.flush()
            for _ in range(64):  # skip banner and echo lines
                line = self._readline()
                if line is None:
                    return None
                m = self._move_re.search(line)
                if m:
                    tok = m.group(1).upper()
                    if tok in ("PS", "PASS"):
                        return self.engine.pass_action
                    col, row = ord(tok[0]) - ord("A"), int(tok[1]) - 1
                    if 0 <= row < self.engine.size and 0 <= col < self.engine.size:
                        return row * self.engine.size + col
                    return None
        except (BrokenPipeError, OSError):
            self.close()
        return None

    def _host_move(self, i, me_words, opp_words, move_count, legal):
        size = self.engine.size
        me_ch, opp_ch = ("X", "O") if int(move_count[i]) % 2 == 0 else ("O", "X")
        me_w, opp_w = int(me_words[i]), int(opp_words[i])
        cells = []
        for r in range(size):
            for c in range(size):
                b = r * 8 + c  # bit row * 8 + col
                cells.append(me_ch if me_w >> b & 1 else opp_ch if opp_w >> b & 1 else "-")
        return self._query_move("".join(cells), me_ch)

    def act(self, boards: Board, generator: Optional[torch.Generator] = None,
            rows: Optional[Rows] = None) -> torch.Tensor:
        if self.binary is None:
            return self._fallback.act(boards, generator, rows)
        return super().act(boards, generator, rows)


class NativeMinimaxPlayer(_HostPlayer):
    """The C++ alpha-beta engine (``csrc/othello_native.cpp``,
    ``oth_best_move``) as a player: negamax with alpha-beta at ``depth``
    plies in the midgame, an exact disc-difference solve once at most
    ``exact_empties`` squares are empty. 8x8 only. The engine is built at
    construction (``ops/native.py``), so a missing compiler fails there and
    not in the middle of a match."""

    def __init__(self, engine: OthelloEngine, depth: int = 4, exact_empties: int = 12):
        if engine.size != 8:
            raise ValueError("NativeMinimaxPlayer requires an 8x8 engine")
        from ..ops import native

        native.load()
        self.engine = engine
        self.depth = int(depth)
        self.exact_empties = int(exact_empties)
        self._native = native
        self.name = f"Minimax(d{self.depth}/e{self.exact_empties})"

    def _host_move(self, i, me_words, opp_words, move_count, legal):
        a, _ = self._native.best_move(int(me_words[i]), int(opp_words[i]), self.depth,
                                      self.exact_empties, self.engine.rules)
        return a


class HumanPlayer(Player):
    """Moves typed by a person for a single game: ``0``-``S*S-1``,
    ``row,col`` or ``pass``, read through ``input_fn``."""

    name = "Human"

    def __init__(self, engine: OthelloEngine, input_fn: Callable[[str], str] = input):
        self.engine = engine
        self.input_fn = input_fn

    def act(self, boards: Board, generator: Optional[torch.Generator] = None,
            rows: Optional[Rows] = None) -> torch.Tensor:
        legal = self.engine.legal_actions(boards).cpu().numpy()
        if legal.shape[0] != 1:
            raise ValueError("HumanPlayer plays one game at a time")
        legal_list = np.flatnonzero(legal[0]).tolist()
        size = self.engine.size
        while True:
            try:
                raw = self.input_fn(
                    f"move (0-{size * size - 1}, row,col, or 'pass') {legal_list}: "
                ).strip().lower()
            except (EOFError, KeyboardInterrupt):
                print("\n(quit)")
                raise SystemExit(0) from None
            try:
                if raw in ("pass", "p"):
                    a = self.engine.pass_action
                elif "," in raw:
                    r, c = (int(x) for x in raw.split(","))
                    a = r * size + c
                else:
                    a = int(raw)
            except ValueError:
                print("invalid input")
                continue
            if a in legal_list:
                return torch.tensor([a], dtype=torch.int64, device=boards.me.device)
            print("illegal move")
