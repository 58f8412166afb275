"""Ring replay buffer on the device.

Port of ``othello_reinforcement_learning_test_tpu/train/buffer.py``: fixed
capacity tensors and a write cursor. ``add`` compacts a whole self-play
trajectory batch into the ring with one scatter; positions are stored as
packed boards (one int64 word per side) and the network features are
recomputed when a minibatch is drawn.

Unlike the JAX package's immutable buffer, ``add``, ``add_prioritized`` and
``update_priorities`` write the buffer's tensors in place (and return the
buffer), which saves a copy of the whole ring per iteration; a caller that
needs the old contents clones first (``ReplayBuffer.clone``). Slot
``capacity`` is a trash slot: masked-out plies are scattered there, so the
scatter needs no branch, and no draw ever reads it.

Draws take an explicit ``torch.Generator`` on the buffer's device. They
cannot reproduce the JAX package's random streams, so the tests hold them
to their distributions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.bitboard import Board, OthelloEngine
from .self_play import Trajectory


@dataclasses.dataclass
class ReplayBuffer:
    me: torch.Tensor  # (C+1,) int64
    opp: torch.Tensor  # (C+1,) int64
    pi: torch.Tensor  # (C+1, A) f32
    value: torch.Tensor  # (C+1,) f32
    cursor: int = 0  # next write position
    filled: int = 0  # valid entries (<= C)
    total_added: int = 0

    @property
    def capacity(self) -> int:
        return self.value.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.value.device

    def clone(self):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone()
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def state_dict(self) -> Dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass
class PrioritizedReplayBuffer(ReplayBuffer):
    priority: Optional[torch.Tensor] = None  # (C+1,) f32, >= 0
    max_priority: float = 1.0  # an f32 value
    alpha: float = 0.6


def create(capacity: int, num_actions: int, device=None) -> ReplayBuffer:
    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayBuffer(me=zeros(capacity + 1, dtype=torch.int64),
                        opp=zeros(capacity + 1, dtype=torch.int64),
                        pi=zeros(capacity + 1, num_actions, dtype=torch.float32),
                        value=zeros(capacity + 1, dtype=torch.float32))


def create_prioritized(capacity: int, num_actions: int, alpha: float = 0.6,
                       device=None) -> PrioritizedReplayBuffer:
    base = create(capacity, num_actions, device)
    return PrioritizedReplayBuffer(
        **base.state_dict(),
        priority=torch.zeros(capacity + 1, dtype=torch.float32, device=device),
        max_priority=1.0, alpha=float(torch.tensor(alpha, dtype=torch.float32)))


def from_state_dict(state: Dict) -> ReplayBuffer:
    cls = PrioritizedReplayBuffer if "priority" in state else ReplayBuffer
    return cls(**state)


def _positions(buffer: ReplayBuffer, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Ring slot of every ply (trash slot C for masked-out ones), the mask
    cut to the last C valid plies, and the number of valid plies."""
    C = buffer.capacity
    offsets = torch.cumsum(mask.to(torch.int64), 0) - 1
    n_valid = int(mask.sum())
    # more valid plies than the capacity: keep only the LAST C, so no slot
    # is written twice and boards stay paired with their pi and value
    mask = mask & (offsets >= n_valid - C)
    pos = torch.where(mask, (buffer.cursor + offsets) % C, C)
    return pos, mask, n_valid


def add(buffer: ReplayBuffer, traj: Trajectory) -> ReplayBuffer:
    """Append every masked-valid ply of a trajectory batch, compacted, in
    order (in place)."""
    pos, _, n_valid = _positions(buffer, traj.mask.reshape(-1))
    buffer.me[pos] = traj.me.reshape(-1)
    buffer.opp[pos] = traj.opp.reshape(-1)
    buffer.pi[pos] = traj.pi.reshape(-1, traj.pi.shape[-1])
    buffer.value[pos] = traj.value.reshape(-1)
    C = buffer.capacity
    buffer.cursor = (buffer.cursor + n_valid) % C
    buffer.filled = min(buffer.filled + n_valid, C)
    buffer.total_added += n_valid
    return buffer


def _batch(buffer: ReplayBuffer, engine: OthelloEngine, idx: torch.Tensor):
    n = idx.shape[0]
    boards = Board(me=buffer.me[idx], opp=buffer.opp[idx],
                   move_count=torch.zeros(n, dtype=torch.int32, device=idx.device),
                   passed=torch.zeros(n, dtype=torch.bool, device=idx.device))
    return engine.features(boards), buffer.pi[idx], buffer.value[idx][:, None]


def sample(buffer: ReplayBuffer, generator: torch.Generator, engine: OthelloEngine,
           batch_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform minibatch -> (features (B, S, S, 3), pi (B, A), value (B, 1)).

    Without replacement once the buffer holds ``batch_size`` entries, as the
    reference's ``random.sample``; with replacement below that (a state
    ``is_ready`` callers never sample from)."""
    dev = buffer.device
    if buffer.filled >= batch_size:
        idx = torch.randperm(buffer.filled, generator=generator, device=dev)[:batch_size]
    else:
        idx = torch.randint(0, max(buffer.filled, 1), (batch_size,),
                            generator=generator, device=dev)
    return _batch(buffer, engine, idx)


def is_ready(buffer: ReplayBuffer, min_size: int) -> bool:
    return buffer.filled >= min_size


# ---------------------------------------------------------------------------
# Prioritized replay: P(i) ~ priority_i^alpha with importance weights; new
# entries get the largest priority seen so far.
# ---------------------------------------------------------------------------


def add_prioritized(buffer: PrioritizedReplayBuffer,
                    traj: Trajectory) -> PrioritizedReplayBuffer:
    pos, mask, _ = _positions(buffer, traj.mask.reshape(-1))
    prio = torch.where(mask, torch.tensor(buffer.max_priority, dtype=torch.float32,
                                          device=buffer.device), 0.0)
    add(buffer, traj)
    buffer.priority[pos] = prio
    return buffer


def _priority_probs(buffer: PrioritizedReplayBuffer) -> torch.Tensor:
    C = buffer.capacity
    valid = torch.arange(C + 1, device=buffer.device) < buffer.filled
    p = torch.where(valid, buffer.priority, 0.0) ** buffer.alpha
    p = torch.where(valid & (p <= 0), 1e-6, p)  # unseen-but-valid guard
    return p / p.sum().clamp_min(1e-8)


def sample_prioritized(buffer: PrioritizedReplayBuffer, generator: torch.Generator,
                       engine: OthelloEngine, batch_size: int):
    """Proportional draws with replacement. Returns (features, pi, value,
    idx, importance_weights), the weights scaled so the largest is 1."""
    probs = _priority_probs(buffer)
    idx = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
    feats, pi, value = _batch(buffer, engine, idx)
    n = float(max(buffer.filled, 1))
    weights = 1.0 / (n * probs[idx]).clamp_min(1e-8)
    weights = weights / weights.max().clamp_min(1e-8)
    return feats, pi, value, idx, weights


def update_priorities(buffer: PrioritizedReplayBuffer, idx: torch.Tensor,
                      td_error: torch.Tensor) -> PrioritizedReplayBuffer:
    """priority[idx] = |td| + 1e-3 (in place)."""
    prio = td_error.abs() + 1e-3
    buffer.priority[idx] = prio
    buffer.max_priority = max(buffer.max_priority, float(prio.max()))
    return buffer


def statistics(buffer: ReplayBuffer) -> Dict[str, float]:
    """Size, fill rate and the value mean and std over the valid entries
    (float32 arithmetic, as the JAX package)."""
    C = buffer.capacity
    v = buffer.value[: buffer.filled]
    n = torch.tensor(float(max(buffer.filled, 1)), dtype=torch.float32, device=v.device)
    mean = v.sum() / n
    var = ((v - mean) ** 2).sum() / n
    return {"size": buffer.filled, "capacity": C,
            "fill_rate": float(torch.tensor(buffer.filled, dtype=torch.float32) / C),
            "total_added": buffer.total_added,
            "value_mean": float(mean), "value_std": float(torch.sqrt(var))}


get_statistics = statistics  # the reference's name
