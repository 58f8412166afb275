"""AlphaZero trainer: self-play -> replay buffer -> SGD -> checkpoint.

Port of ``othello_reinforcement_learning_test_tpu/train/trainer.py``. Each
iteration (``AlphaZeroTrainer._train_iteration``):

1. plays ``self_play_episodes_per_iter`` games with the current network,
   or with gating on, the best network so far
   (``system.self_play_net_variant``: ``"xla"`` is the plain eval forward,
   ``"int8_xla"`` the plain quantized trunk, and every other variant of
   ``FusedInference`` runs its hand-written trunk kernel); the fused network
   is rebuilt from the parameters before every self-play, since
   ``FusedInference`` folds its weights once;
2. adds the trajectories to the ring buffer;
3. takes ``train_epochs_per_iter`` SGD minibatch steps (a Python loop in
   place of the JAX ``scan``);
4. writes the metrics;
5. with ``training.gating.enabled``, every ``gating.interval`` iterations
   plays a gate match of the candidate (the current network) against the
   best so far through the self-play forward, and adopts the candidate as
   best when its decisive win rate (wins / (wins + losses), 0.5 when every
   game is drawn) reaches ``gating.win_threshold``;
6. every ``checkpoint_interval`` iterations writes a full checkpoint, the
   best network included.

Semantics kept from the JAX package:

- loss: policy cross-entropy ``-mean(sum(target * log_probs))`` plus value
  MSE, unweighted (importance-weighted for prioritized replay);
- optimizer: optax ``chain(add_decayed_weights(wd), sgd(lr, momentum))``,
  which is ``torch.optim.SGD(momentum, weight_decay, dampening=0,
  nesterov=False)``; weight decay applies to every parameter, BatchNorm
  scales and shifts included;
- learning rate: set before every optimizer step from
  :func:`make_lr_schedule` at the step count *before* the step, as optax
  counts;
- the training forward computes in ``compute_dtype`` (bfloat16 by default,
  as the JAX network) with float32 parameters and BatchNorm statistics;
- ``train`` self-heals: after a failed iteration it restores the last
  checkpoint this run wrote or loaded, or, before the first one, the
  snapshot taken at the iteration's start (best network included), within
  a bounded number of consecutive retries;
- on resume the config's gating setting wins over the checkpoint's: a
  checkpoint's best network is restored only with gating on, and with
  gating on and no best network in the checkpoint, best is the restored
  candidate.

Data parallelism (the JAX ``dp`` mesh) runs over a ``torch.distributed``
process group, one device a rank (``parallel/mesh.py``); ``system.mesh_devices``
is the world size the run expects. Under a group of W > 1 ranks:

- self-play: each rank plays ``ceil(games / W)`` games, seeded by
  ``fold_in_process`` of the drawn seed (``system.distributed_self_play:
  local``, the default off a TPU), or its shard of the global batch from
  the one drawn seed (``global``); the trajectories are all-gathered in rank
  order and every rank adds them to its own buffer, so the buffers stay
  identical;
- SGD: every rank draws the same global minibatch (and augmentation) and
  keeps its slice; BatchNorm takes the global moments, the parameter
  gradients are averaged over the ranks (the full batch's gradient), the
  logged losses too; prioritized replay all-gathers the TD errors before
  updating priorities;
- the gate match shards its games over the ranks, and every rank makes the
  same decision;
- rank 0 writes checkpoints while the others wait; each rank writes its
  metrics (rank r > 0 under ``<log_dir>/rank{r}``);
- a failed iteration is re-raised on the rank that failed, never healed:
  a local restore while the peers wait in a collective would hang them.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..evaluation.arena import Arena, MatchSummary
from ..evaluation.players import MCTSPlayer
from ..models.convert import from_jax_variables, init_train_variables, to_jax_variables
from ..models.fused_resnet import PORTED_VARIANTS, FusedInference
from ..models.resnet import OthelloResNet, param_count
from ..ops.bitboard import OthelloEngine, get_engine
from ..parallel import mesh
from ..parallel.mesh import Rows, draw_rows
from ..utils.metrics import MetricsWriter
from . import buffer as buffer_lib
from . import checkpoint as ckpt_lib
from .self_play import Trajectory, auto_cond_interval, play_games


@dataclasses.dataclass
class TrainState:
    """The network (float32 parameters and BatchNorm statistics), its SGD
    optimizer, and the counters. Steps update it in place."""

    model: OthelloResNet
    optimizer: torch.optim.SGD
    step: int = 0  # optimizer steps taken
    iteration: int = 0  # completed iterations

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "iteration": self.iteration}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.iteration = int(state["iteration"])


def make_lr_schedule(config: Dict) -> Callable[[int], float]:
    """Learning rate at optimizer step k (counted from 0 before the step),
    by ``training.lr_schedule``:

    - ``"step"`` (default): ``lr * gamma ** (k // (lr_step_size *
      train_epochs_per_iter))``, a staircase every ``lr_step_size``
      iterations;
    - ``"constant"``: ``lr``.
    """
    tc = config.get("training", {})
    lr = float(tc.get("lr", 1e-3))
    if str(tc.get("lr_schedule", "step")) == "constant":
        return lambda k: lr
    gamma = float(tc.get("lr_gamma", 0.1))
    every = int(tc.get("lr_step_size", 100)) * max(int(tc.get("train_epochs_per_iter", 10)), 1)
    return lambda k: lr * gamma ** (k // every)


def make_optimizer(model: OthelloResNet, config: Dict) -> torch.optim.SGD:
    tc = config.get("training", {})
    return torch.optim.SGD(model.parameters(), lr=make_lr_schedule(config)(0),
                           momentum=float(tc.get("momentum", 0.9)),
                           weight_decay=float(tc.get("weight_decay", 1e-4)),
                           dampening=0.0, nesterov=False)


def loss_fn(model: OthelloResNet, feats: torch.Tensor, target_pi: torch.Tensor,
            target_v: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """Train-mode forward (updates the BatchNorm running statistics in
    place) -> ``(total, policy_loss, value_loss)``."""
    log_probs, value = model(feats, train=True, compute_dtype=compute_dtype)
    policy_loss = -torch.mean(torch.sum(target_pi * log_probs, dim=-1))
    value_loss = torch.mean((value - target_v) ** 2)
    return policy_loss + value_loss, policy_loss, value_loss


def optimizer_step(state: TrainState, schedule: Callable[[int], float]) -> None:
    """Apply the gradients in ``.grad`` at the schedule's learning rate for
    the current step count, then count the step."""
    lr = schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def _sgd_step(state: TrainState, loss: torch.Tensor,
              schedule: Callable[[int], float]) -> None:
    """Backward, the gradients averaged over the ranks of a process group,
    one optimizer step."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh.process_count() > 1:
        mesh.all_reduce_mean_grads(state.model)
    optimizer_step(state, schedule)


def _metrics(total: torch.Tensor, pl: torch.Tensor, vl: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The step's losses, their means over the ranks of a process group (the
    global batch's losses); they stay on the device."""
    losses = torch.stack([total, pl, vl]).detach()
    if mesh.process_count() > 1:
        losses = mesh.global_mean(losses)
    return dict(zip(("loss", "policy_loss", "value_loss"), losses.unbind()))


def train_on_batch(state: TrainState, feats: torch.Tensor, pi: torch.Tensor,
                   value: torch.Tensor, schedule: Callable[[int], float],
                   compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One SGD step on a given batch (under a process group, this rank's
    share of the global batch)."""
    total, pl, vl = loss_fn(state.model, feats, pi, value, compute_dtype)
    _sgd_step(state, total, schedule)
    return _metrics(total, pl, vl)


def _rank_rows(batch_size: int) -> Optional[Rows]:
    """This rank's rows of a global minibatch, None without a process group
    of more than one rank."""
    if mesh.process_count() == 1:
        return None
    return batch_size, mesh.local_slice(batch_size)


def _augment(engine: OthelloEngine, feats: torch.Tensor, pi: torch.Tensor,
             generator: torch.Generator, rows: Optional[Rows] = None):
    """One uniformly drawn D4 image of each (features, pi) pair; with
    ``rows`` the pairs are those rows of a global batch, and the images
    are drawn at its shape."""
    f8, p8 = engine.symmetries(feats, pi)
    index = torch.arange(feats.shape[0], device=feats.device)
    which = draw_rows(lambda shape: torch.randint(0, 8, shape, generator=generator,
                                                  device=feats.device),
                      (feats.shape[0],), rows)
    return f8[index, which], p8[index, which]


def train_step(state: TrainState, engine: OthelloEngine, buf: buffer_lib.ReplayBuffer,
               generator: torch.Generator, batch_size: int,
               schedule: Callable[[int], float], augment: bool = False,
               compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One SGD minibatch step drawn from the buffer (one reference "epoch").
    Under a process group every rank draws the global minibatch and trains
    on its slice."""
    feats, pi, v = buffer_lib.sample(buf, generator, engine, batch_size)
    rows = _rank_rows(batch_size)
    if rows is not None:
        feats, pi, v = feats[rows[1]], pi[rows[1]], v[rows[1]]
    if augment:
        feats, pi = _augment(engine, feats, pi, generator, rows)
    return train_on_batch(state, feats, pi, v, schedule, compute_dtype)


def train_steps(state: TrainState, engine: OthelloEngine, buf: buffer_lib.ReplayBuffer,
                generator: torch.Generator, batch_size: int, num_steps: int,
                schedule: Callable[[int], float], augment: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16) -> List[Dict[str, torch.Tensor]]:
    """``num_steps`` of :func:`train_step`; per-step metrics."""
    return [train_step(state, engine, buf, generator, batch_size, schedule, augment,
                       compute_dtype) for _ in range(num_steps)]


def train_step_prioritized(state: TrainState, engine: OthelloEngine,
                           buf: buffer_lib.PrioritizedReplayBuffer,
                           generator: torch.Generator, batch_size: int,
                           schedule: Callable[[int], float], augment: bool = False,
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> Dict[str, torch.Tensor]:
    """Proportional draw, importance-weighted losses, one SGD step, then
    the drawn entries' priorities set from their TD errors. Under a process
    group each rank trains on its slice of the global draw, normalised by
    the global weights' sum over W (so the ranks' mean is the global loss),
    and the TD errors are all-gathered before the priorities update."""
    feats, pi, v, idx, weights = buffer_lib.sample_prioritized(buf, generator, engine,
                                                               batch_size)
    norm = weights.sum()
    rows = _rank_rows(batch_size)
    if rows is not None:
        feats, pi, v, weights = (t[rows[1]] for t in (feats, pi, v, weights))
        norm = norm / torch.tensor(float(mesh.process_count()), dtype=norm.dtype,
                                   device=norm.device)
    if augment:
        feats, pi = _augment(engine, feats, pi, generator, rows)
    log_probs, value = state.model(feats, train=True, compute_dtype=compute_dtype)
    pl = -torch.sum(weights * torch.sum(pi * log_probs, dim=-1)) / norm
    err = value[:, 0] - v[:, 0]
    vl = torch.sum(weights * err ** 2) / norm
    total = pl + vl
    _sgd_step(state, total, schedule)
    td = err.detach().abs()
    if rows is not None:
        td = mesh.all_gather_leading(td)
    buffer_lib.update_priorities(buf, idx, td)
    return _metrics(total, pl, vl)


def apply_eval(model: OthelloResNet, compute_dtype: torch.dtype = torch.bfloat16):
    """The eval-mode network forward (variant ``"xla"``: no kernel)."""

    @torch.no_grad()
    def fn(x: torch.Tensor):
        return model(x, train=False, compute_dtype=compute_dtype)

    return fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _concat(chunks: List[Trajectory]) -> Trajectory:
    if len(chunks) == 1:
        return chunks[0]
    return Trajectory(*(torch.cat(fields, dim=0) for fields in zip(*chunks)))


class AlphaZeroTrainer:
    """Host-side orchestration with the reference trainer's API (``train``,
    ``save_checkpoint``, ``load_checkpoint``), resume and self-healing.

    ``device``: ``None`` takes ``system.device`` (``"auto"`` means CUDA),
    which must then be available; ``"cpu"`` runs on the CPU. Under a
    process group each rank takes ``parallel.mesh.local_device`` of it.
    ``compute_dtype``: the training and ``"xla"`` self-play forward's
    compute type (bfloat16 unless given).
    """

    def __init__(self, config: Dict, engine: Optional[OthelloEngine] = None,
                 model: Optional[OthelloResNet] = None, seed: Optional[int] = None,
                 log_cb: Optional[Callable[[str], None]] = print, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.config = config
        gc = config.get("game", {})
        size = int(gc.get("size", config.get("model", {}).get("board_size", 8)))
        self.engine = engine or get_engine(size, gc.get("rules", "reference"))
        self.log = log_cb or (lambda s: None)

        sc = config.get("system", {})
        if device is None and str(sc.get("device", "auto")) != "auto":
            device = sc["device"]
        self.device = mesh.local_device(device)
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.seed = seed if seed is not None else int(sc.get("seed", 42))
        # host generator: self-play seeds; device generator: minibatch draws.
        # Every rank seeds both alike.
        self.rng = torch.Generator().manual_seed(self.seed)
        self.sample_rng = torch.Generator(device=self.device).manual_seed(self._draw_seed())
        self.max_recovery_retries = int(sc.get("max_recovery_retries", 3))
        # data parallelism: one rank a process, system.mesh_devices the world
        # size the run expects
        self.process_count = mesh.process_count()
        self.rank = mesh.process_index()
        self.distributed = self.process_count > 1
        mesh_devices = int(sc.get("mesh_devices") or self.process_count)
        if mesh_devices != self.process_count:
            if self.process_count == 1:
                raise ValueError(
                    f"system.mesh_devices: {mesh_devices} asks for {mesh_devices} data-parallel "
                    "ranks, one process a device, and this is a single process: start "
                    f"{mesh_devices} processes with --coordinator/--num-processes/--process-id "
                    "(or torchrun)")
            raise ValueError(f"system.mesh_devices: {mesh_devices} does not match the "
                             f"{self.process_count} processes of the group")
        self._warned_game_rounding = False
        # the liveness tests' decimation, and the distributed self-play design
        ci = config.get("self_play", {}).get("cond_interval")
        if ci in (None, 0, "auto"):
            self.cond_interval = auto_cond_interval()
            if self.cond_interval > 1:
                self.log(f"self_play.cond_interval auto-selected: {self.cond_interval} "
                         f"(multi-process {self.device.type} transport is cond-latency-bound; "
                         "set self_play.cond_interval to override)")
        else:
            self.cond_interval = int(ci)
        self.distributed_self_play = str(sc.get("distributed_self_play") or "auto")
        if self.distributed_self_play not in ("auto", "local", "global"):
            raise ValueError("system.distributed_self_play must be auto|local|global, "
                             f"got {self.distributed_self_play!r}")

        tc = config.get("training", {})
        self.batch_size = int(tc.get("batch_size", 256))
        if self.batch_size % self.process_count:
            raise ValueError(f"training.batch_size {self.batch_size} must divide by the "
                             f"{self.process_count} data-parallel ranks")
        self.num_iterations = int(tc.get("num_iterations", 1000))
        self.episodes_per_iter = int(tc.get("self_play_episodes_per_iter", 100))
        self.epochs_per_iter = int(tc.get("train_epochs_per_iter", 10))
        self.checkpoint_interval = int(tc.get("checkpoint_interval", 10))
        self.buffer_capacity = int(tc.get("replay_buffer_size", 100_000))
        self.augment = bool(tc.get("augment_symmetries", False))
        if self.augment and self.engine.rules == "reference":
            # the reference rule set is not D4-symmetric: rotated (features,
            # pi) pairs would disagree with the engine
            self.log("warning: augment_symmetries disabled — reference rules are "
                     "not D4-symmetric (use game.rules: standard)")
            self.augment = False
        self.prioritized = bool(tc.get("prioritized_replay", False))
        gate = tc.get("gating") or {}
        if not isinstance(gate, dict):
            raise ValueError("training.gating must be a mapping, e.g. {enabled: true, "
                             f"games: 40, win_threshold: 0.55}}; got {gate!r}")
        self.gating_enabled = bool(gate.get("enabled", False))
        self.gating_games = int(gate.get("games", 40) or 40)
        self.gating_threshold = float(gate.get("win_threshold", 0.55))
        self.gating_interval = int(gate.get("interval") or tc.get("checkpoint_interval", 10))
        self.gating_sims = int(gate.get("num_simulations")
                               or config.get("mcts", {}).get("num_simulations", 25))
        self.gating_opening = int(gate.get("opening_random_plies", 4))

        mcc = config.get("mcts", {})
        self.num_simulations = int(mcc.get("num_simulations", 25))
        self.c_puct = float(mcc.get("c_puct", 1.0))
        self.dirichlet_alpha = float(mcc.get("dirichlet_alpha", 0.3))
        self.dirichlet_epsilon = float(mcc.get("dirichlet_epsilon", 0.25))
        spc = config.get("self_play", {})
        self.temperature_threshold = int(spc.get("temperature_threshold", 15))
        npg = spc.get("num_parallel_games")
        self.num_parallel_games = int(npg) if npg else None

        paths = config.get("paths", {})
        self.checkpoint_dir = paths.get("checkpoint_dir", "data/models")
        self.log_dir = paths.get("log_dir", "data/logs")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.writer = MetricsWriter(os.path.join(self.log_dir, f"rank{self.rank}")
                                    if self.rank else self.log_dir)

        mc = config.get("model", {})
        if model is None:
            model = OthelloResNet(int(mc.get("num_blocks", 10)),
                                  int(mc.get("num_filters", 128)), size)
            model.load_state_dict(from_jax_variables(init_train_variables(
                model.num_blocks, model.num_filters, self._draw_seed(), size,
                model.value_hidden)))
        self.model = model.to(self.device)
        self.schedule = make_lr_schedule(config)
        self.state = TrainState(self.model, make_optimizer(self.model, config))
        if self.prioritized:
            self.buffer = buffer_lib.create_prioritized(
                self.buffer_capacity, self.engine.num_actions, device=self.device)
        else:
            self.buffer = buffer_lib.create(self.buffer_capacity, self.engine.num_actions,
                                            device=self.device)
        self.variant = str(sc.get("self_play_net_variant") or "xla")
        if self.variant != "xla" and self.variant not in PORTED_VARIANTS:
            raise ValueError(f"system.self_play_net_variant {self.variant!r} is unknown: "
                             f"'xla' or one of {PORTED_VARIANTS}")
        if self.variant != "xla":
            self.log(f"self-play inference: fused trunk kernel ({self.variant})")
        # arena gating: self-play plays the best network so far (a state dict
        # on the device, run through a model of its own); the candidate must
        # beat it in a gate match to replace it
        self.best: Optional[Dict[str, torch.Tensor]] = None
        self._best_model: Optional[OthelloResNet] = None
        if self.gating_enabled:
            self.best = self._model_state()
            self._best_model = copy.deepcopy(self.model)
        # self-healing: the last checkpoint THIS run wrote or loaded, and
        # before the first one a snapshot of the state at the iteration's start
        self._heal_ckpt: Optional[str] = None
        self._pre_iter_snapshot = None
        self.last_checkpoint_seconds = 0.0
        if self.distributed:
            self.log(f"multi-process: rank {self.rank} of {self.process_count} "
                     f"({torch.distributed.get_backend()}), data-parallel over "
                     f"{self.process_count} devices")
        self.log(f"model: {self.model.num_blocks} blocks x {self.model.num_filters} "
                 f"filters, {param_count(self.model):,} params; engine: {self.engine}; "
                 f"device: {self.device}")

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.rng))

    def _model_state(self) -> Dict[str, torch.Tensor]:
        """A copy of the current network's parameters and statistics."""
        return {k: t.detach().clone() for k, t in self.model.state_dict().items()}

    # -- checkpointing -----------------------------------------------------
    def _rng_state(self) -> Dict:
        return {"host": self.rng.get_state(), "sample": self.sample_rng.get_state()}

    def _set_rng_state(self, state: Dict) -> None:
        self.rng.set_state(state["host"])
        self.sample_rng.set_state(state["sample"])

    def save_checkpoint(self, name: str) -> str:
        """Full checkpoint (train state, buffer, generators, config): a
        resume from it is bit-identical to an uninterrupted run. Under a
        process group rank 0 writes it (every rank holds the same state) and
        the others wait for it."""
        path = os.path.join(self.checkpoint_dir, name + ckpt_lib.SUFFIX)
        if self.rank == 0:
            ckpt_lib.save_full(path, train_state=self.state.state_dict(),
                               buffer=self.buffer.state_dict(), rng=self._rng_state(),
                               config=self.config, best=self.best)
        mesh.barrier()
        self._heal_ckpt = path
        self._pre_iter_snapshot = None
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore the train state, and for format-2 checkpoints whose buffer
        matches the config, the buffer, generators and gating best network
        too; otherwise the run resumes with an empty buffer (a warning says
        so). With gating on and no best network restored, best is the
        restored candidate."""
        meta = ckpt_lib.load_meta(path)
        restored_best = False
        if meta.get("format", 1) >= 2:
            if (int(meta.get("buffer_capacity", -1)) != self.buffer.capacity
                    or meta.get("buffer_class") != type(self.buffer).__name__):
                self.state.load_state_dict(ckpt_lib.load_train_state(path))
                self.log(f"warning: checkpoint buffer ({meta.get('buffer_class')}, cap "
                         f"{meta.get('buffer_capacity')}) doesn't match config "
                         f"({type(self.buffer).__name__}, cap {self.buffer.capacity}); "
                         "resuming with an empty buffer")
            else:
                restored = ckpt_lib.load_full(path)
                self.state.load_state_dict(restored["train_state"])
                self.buffer = buffer_lib.from_state_dict(
                    {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                     for k, v in restored["buffer"].items()})
                self._set_rng_state(restored["rng"])
                if "best" in restored:
                    if self.gating_enabled:
                        self.best = {k: t.to(self.device) for k, t in restored["best"].items()}
                        restored_best = True
                    else:
                        # the config's gating setting wins over the checkpoint's
                        self.log("note: checkpoint has a gating best-network but "
                                 "training.gating.enabled is false; ignoring it")
        else:
            self.state.load_state_dict(ckpt_lib.load(path))
            self.log("warning: format-1 checkpoint (no buffer/RNG state); "
                     "resuming with an empty buffer")
        if self.gating_enabled and not restored_best:
            # never leave gated self-play on the pre-resume network
            self.best = self._model_state()
        self._heal_ckpt = path
        self.log(f"resumed from {path} at iteration {self.state.iteration}")

    # -- main loop ---------------------------------------------------------
    def variables(self) -> Dict:
        """The network as a flax ``{params, batch_stats}`` tree of numpy
        arrays."""
        return to_jax_variables(self.model.state_dict())

    def _net(self, model: OthelloResNet):
        """The self-play forward of ``model``'s current parameters."""
        if self.variant == "xla":
            return apply_eval(model, self.compute_dtype)
        return FusedInference(model, variant=self.variant)

    def _best_net(self):
        self._best_model.load_state_dict(self.best)
        return self._net(self._best_model)

    def selfplay_net(self):
        """The self-play network: the best so far with gating on, else the
        current one."""
        return self._best_net() if self.gating_enabled else self._net(self.model)

    def _play(self, net, num_games: int, add_noise: bool, seed: int, **kw) -> Trajectory:
        return play_games(
            self.engine, net, num_games, self.num_simulations, c_puct=self.c_puct,
            dirichlet_alpha=self.dirichlet_alpha, dirichlet_epsilon=self.dirichlet_epsilon,
            temperature_threshold=self.temperature_threshold, add_noise=add_noise,
            seed=seed, device=self.device, cond_interval=self.cond_interval, **kw)

    def run_self_play(self, num_games: int, add_noise: bool = True) -> Trajectory:
        """``num_games`` games from the self-play network. Under a process
        group every rank returns the global trajectory (see the module
        docstring); ``num_games`` rounds up to a multiple of the ranks."""
        net = self.selfplay_net()
        if self.distributed:
            world = self.process_count
            per = -(-num_games // world)
            total = per * world
            if total != num_games and not self._warned_game_rounding:
                self._warned_game_rounding = True
                self.log(f"distributed: rounding {num_games} games/iter up to {total} "
                         f"({per}/process) for even sharding")
            seed = self._draw_seed()
            design = "local" if self.distributed_self_play == "auto" else self.distributed_self_play
            if design == "global":
                traj = self._play(net, total, add_noise, seed, shard=(self.rank, world))
            else:
                traj = self._play(net, per, add_noise, mesh.fold_in_process(seed))
            return mesh.all_gather_leading(traj)
        chunk = self.num_parallel_games or num_games
        chunks = []
        remaining = num_games
        while remaining > 0:
            n = min(chunk, remaining)
            chunks.append(self._play(net, n, add_noise, self._draw_seed()))
            remaining -= n
        return _concat(chunks)

    def _snapshot(self):
        return (copy.deepcopy(self.state.state_dict()), self.buffer.clone(),
                copy.deepcopy(self._rng_state()), copy.deepcopy(self.best))

    def _gate_match(self, seed: int) -> Tuple[float, MatchSummary]:
        """The candidate (current parameters) against the best so far, both
        through the self-play forward: ``(decisive win rate, summary)``, the
        rate wins / (wins + losses), 0.5 if every game is drawn. Under a
        process group each rank plays its share of the games and every rank
        gets the whole summary. Separate so that tests can rig the
        outcome."""
        def player(net):
            return MCTSPlayer(self.engine, net, num_simulations=self.gating_sims,
                              c_puct=self.c_puct)

        shard = (self.rank, self.process_count) if self.distributed else None
        s = Arena(self.engine, device=self.device, shard=shard).play_matches(
            player(self._net(self.model)), player(self._best_net()), self.gating_games, seed,
            opening_random_plies=self.gating_opening)
        decisive = s.wins + s.losses
        return (s.wins / decisive if decisive else 0.5), s

    def run_gating(self, iteration: int) -> Optional[bool]:
        """Gate the candidate if it is due at this iteration: True when it
        is adopted as best, False when best is kept, None when gating is off
        or not due."""
        if not self.gating_enabled or iteration % self.gating_interval != 0:
            return None
        t0 = time.time()
        win_rate, s = self._gate_match(self._draw_seed())
        accepted = win_rate >= self.gating_threshold
        if accepted:
            self.best = self._model_state()
        self.writer.scalar("Gating/win_rate", win_rate, iteration)
        self.writer.scalar("Gating/accepted", float(accepted), iteration)
        self.log(f"gating @ iter {iteration}: candidate {s.wins}W-{s.losses}L-{s.draws}D "
                 f"(decisive {win_rate:.1%}) -> "
                 f"{'ADOPTED as best' if accepted else 'rejected (best kept)'} "
                 f"[{time.time() - t0:.1f}s]")
        return accepted

    def train(self, num_iterations: Optional[int] = None,
              episodes_per_iter: Optional[int] = None) -> Dict[str, float]:
        num_iterations = num_iterations or self.num_iterations
        episodes = episodes_per_iter or self.episodes_per_iter
        last: Dict[str, float] = {}
        recent_iter_times: list = []
        recent_losses: list = []
        it = self.state.iteration
        # the failure streak is keyed to the failing iteration, so replayed
        # good iterations after a rewind cannot mask a deterministic fault
        fail_streak = 0
        last_failed_it = -1
        while it < num_iterations:
            try:
                if (self.max_recovery_retries > 0 and not self.distributed
                        and self._heal_ckpt is None):
                    self._pre_iter_snapshot = (it, self._snapshot())
                last = self._train_iteration(it, episodes, num_iterations,
                                             recent_iter_times, recent_losses)
                it += 1
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — a failed iteration
                if self.distributed:
                    # a local restore while the peers wait in a collective
                    # would hang them: fail fast, restart with --resume latest
                    self.log(f"iteration {it + 1} failed in a multi-process run "
                             f"({type(e).__name__}: {e}); self-healing is single-process "
                             "only — re-raising")
                    raise
                fail_streak = fail_streak + 1 if it == last_failed_it else 1
                last_failed_it = it
                if fail_streak > self.max_recovery_retries:
                    self.log(f"iteration {it + 1} failed {fail_streak} times; giving up")
                    raise
                if self._heal_ckpt is None and self._pre_iter_snapshot is None:
                    raise  # recovery disabled: nothing to roll back to
                self.log(f"iteration {it + 1} failed ({type(e).__name__}: {e}); "
                         f"self-healing attempt {fail_streak}/{self.max_recovery_retries}")
                it = self._self_heal()
        self.save_checkpoint("final_model")
        self.writer.flush()
        return last

    def _self_heal(self) -> int:
        """Restore the last checkpoint this run wrote or loaded (never a scan
        of the directory, which may hold another run's files), or before the
        first one the snapshot of the failed iteration's start. Returns the
        iteration to resume from."""
        if self._heal_ckpt is not None:
            self.log(f"self-heal: restoring {self._heal_ckpt}")
            self.load_checkpoint(self._heal_ckpt)
            return self.state.iteration
        resume_it, (state, buf, rng, best) = self._pre_iter_snapshot
        self.log(f"self-heal: no checkpoint yet; rolling back to the start of "
                 f"iteration {resume_it + 1}")
        # restore copies, so the snapshot stays intact for a further retry
        self.state.load_state_dict(copy.deepcopy(state))
        self.buffer = buf.clone()
        self._set_rng_state(rng)
        self.best = copy.deepcopy(best)
        return resume_it

    def _train_iteration(self, it: int, episodes: int, num_iterations: int,
                         recent_iter_times: list, recent_losses: list) -> Dict[str, float]:
        """Self-play -> buffer -> SGD steps -> metrics -> gating -> periodic
        checkpoint. An exception leaves recovery to ``train``."""
        t0 = time.time()
        traj = self.run_self_play(episodes)
        _sync(self.device)
        sp_time = time.time() - t0

        if self.prioritized:
            buffer_lib.add_prioritized(self.buffer, traj)
        else:
            buffer_lib.add(self.buffer, traj)

        t1 = time.time()
        losses: List[Dict[str, torch.Tensor]] = []
        if buffer_lib.is_ready(self.buffer, self.batch_size):
            args = (self.state, self.engine, self.buffer, self.sample_rng, self.batch_size)
            kw = dict(schedule=self.schedule, augment=self.augment,
                      compute_dtype=self.compute_dtype)
            if self.prioritized:
                losses = [train_step_prioritized(*args, **kw)
                          for _ in range(self.epochs_per_iter)]
            else:
                losses = train_steps(*args, self.epochs_per_iter, **kw)
        _sync(self.device)
        tr_time = time.time() - t1

        self.state.iteration = it + 1
        stats = buffer_lib.statistics(self.buffer)

        def avg(k):
            return float(torch.stack([m[k] for m in losses]).mean()) if losses else 0.0

        scalars = {
            "Loss/train": avg("loss"),
            "Loss/policy": avg("policy_loss"),
            "Loss/value": avg("value_loss"),
            "Time/self_play": sp_time,
            "Time/train": tr_time,
            "Buffer/size": float(stats["size"]),
            "Buffer/value_mean": stats["value_mean"],
            "Buffer/value_std": stats["value_std"],
            "SelfPlay/avg_moves": float(traj.num_moves.to(torch.float32).mean()),
        }
        for k, v in scalars.items():
            self.writer.scalar(k, v, it + 1)
        self.writer.flush()
        recent_iter_times.append(sp_time + tr_time)
        del recent_iter_times[:-10]
        recent_losses.append(scalars["Loss/train"])
        del recent_losses[:-5]
        eta = (num_iterations - it - 1) * (sum(recent_iter_times) / len(recent_iter_times))
        trend = ""
        if len(recent_losses) >= 2:
            trend = " ↓" if recent_losses[-1] < recent_losses[0] else " ↑"
        self.log(f"iter {it + 1}/{num_iterations} loss={scalars['Loss/train']:.4f}{trend} "
                 f"self_play={sp_time:.1f}s train={tr_time:.1f}s "
                 f"buffer={stats['size']} eta={eta / 60:.1f}m")

        self.run_gating(it + 1)

        if (it + 1) % self.checkpoint_interval == 0:
            t2 = time.time()
            self.save_checkpoint(f"checkpoint_iter_{it + 1:06d}")
            self.last_checkpoint_seconds = time.time() - t2
        return scalars

    def close(self) -> None:
        self.writer.close()
