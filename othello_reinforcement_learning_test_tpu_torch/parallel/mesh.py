"""Data parallelism over processes: the process group and its collectives.

Port of ``othello_reinforcement_learning_test_tpu/parallel/mesh.py``. The
JAX package shards the games and minibatch axis over a ``dp`` mesh and lets
XLA insert the collectives. PyTorch has no SPMD annotations, so here each
process is one rank of a ``torch.distributed`` process group with one
device, and the collectives are explicit:

- a rank's share of a global batch of ``n`` is its contiguous slice
  :func:`local_slice` ``[r * n // W, (r + 1) * n // W)``, the order of JAX's
  process-major mesh; random draws are taken at the global batch's shape
  from a generator every rank seeds alike, then sliced (:func:`draw_rows`),
  so a sharded run draws what the unsharded run draws;
- :func:`all_gather_leading` concatenates the ranks' leading axes in rank
  order (``global_from_local_leading``);
- :func:`all_reduce_mean_grads` averages the parameter gradients (XLA's
  inserted ``psum``), and :func:`global_mean` is the autograd-aware
  all-reduce that gives BatchNorm the global batch's moments;
- :func:`broadcast` and :func:`barrier`.

``system.mesh_devices: N`` is the world size a run expects (one device a
process); a single-process mesh over N local devices has no counterpart.

Under gloo, CUDA tensors are staged through host memory for each collective,
as gloo does inside; the compute stays on the card. NCCL takes them as they
are, and needs one card a rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# a rank's rows of a global batch: (global rows, this rank's slice)
Rows = Tuple[int, slice]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device=None,
                           timeout: Optional[float] = None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    With ``coordinator_address`` (``host:port``, rank 0 listens there), the
    group is ``tcp://coordinator_address`` with ``num_processes`` ranks,
    this one ``process_id``. Without it, torchrun's environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) configures
    it. ``backend=None`` takes ``nccl`` when the rank's ``device`` (as
    :func:`local_device` reads it: CUDA unless ``"cpu"``) is CUDA, else
    ``gloo``. ``timeout``: seconds a collective may wait."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator_address is None:
        rank = int(os.environ.get("RANK", 0))
        kwargs["init_method"] = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        rank = int(process_id)
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=rank)
    if backend == "nccl" and dev.index is None:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _group_up() else 0


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return _rank()


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if _group_up() else 1


def local_device(device=None) -> torch.device:
    """The rank's device: ``"cpu"`` is the CPU; otherwise CUDA, each rank of
    a multi-process group on ``cuda:{rank % device_count}``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and process_count() > 1:
        return torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


_MASK64 = (1 << 64) - 1


def fold_in_process(seed: int, process_index: Optional[int] = None) -> int:
    """A per-rank seed from a seed every rank shares: a splitmix64 mix of
    (seed, rank), deterministic, different for each rank, in [0, 2**62)."""
    if process_index is None:
        process_index = _rank()
    z = (int(seed) + (int(process_index) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 2


def local_slice(n: int, rank: Optional[int] = None, world: Optional[int] = None) -> slice:
    """Rank ``rank``'s contiguous share of a global batch of ``n``."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return slice(rank * n // world, (rank + 1) * n // world)


def shard_rows(n: int, shard: Optional[Tuple[int, int]]) -> Optional[Rows]:
    """The rows of a ``(rank, world)`` shard of a global batch of ``n``, or
    None for the whole batch."""
    if shard is None:
        return None
    return n, local_slice(n, *shard)


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int],
              rows: Optional[Rows]) -> torch.Tensor:
    """``draw(shape)``, or with ``rows`` this rank's rows of the draw taken at
    the global batch's shape."""
    if rows is None:
        return draw(tuple(shape))
    n, sl = rows
    return draw((n, *shape[1:]))[sl]


# -- collectives ---------------------------------------------------------------


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend takes: a host copy of a CUDA tensor under gloo."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.cpu()
    return t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, a new tensor on ``t``'s device."""
    buf = _staged(t.detach()).clone()
    dist.all_reduce(buf)
    return buf.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, differentiable: each rank's backward
    carries its share of the gradient through every rank's input. Without a
    process group it is ``t``."""
    if not _group_up():
        return t
    world = torch.tensor(float(process_count()), dtype=t.dtype, device=t.device)
    return _AllReduceSum.apply(t) / world


def all_reduce_mean_grads(model: torch.nn.Module) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks, in one
    collective over the flattened gradients."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not _group_up() or not grads:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    flat = flat / torch.tensor(float(process_count()), dtype=flat.dtype, device=flat.device)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _map(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(x, fn) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _leaves(tree: Any) -> list:
    out = []
    _map(tree, lambda t: out.append(t) or t)
    return out


def all_gather_leading(tree: Any) -> Any:
    """Concatenate every tensor's leading axis over the ranks, in rank order,
    on each rank (the leading sizes may differ between ranks, but agree
    within one rank's tree)."""
    if not _group_up():
        return tree
    world = process_count()
    leaves = _leaves(tree)
    n = leaves[0].shape[0] if leaves else 0
    sizes = _sizes(n)
    most = max(sizes)

    def gather(x: torch.Tensor) -> torch.Tensor:
        src = _staged(x.detach())
        if src.shape[0] < most:
            src = torch.cat([src, src.new_zeros((most - src.shape[0], *src.shape[1:]))])
        bufs = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(bufs, src.contiguous())
        return torch.cat([b[:s] for b, s in zip(bufs, sizes)]).to(x.device)

    return _map(tree, gather)


def _sizes(n: int) -> list:
    """Every rank's ``n``, in rank order."""
    t = torch.tensor([n], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    bufs = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(bufs, t)
    return [int(b) for b in bufs]


def broadcast(tree: Any, src: int = 0) -> Any:
    """Overwrite every tensor in ``tree`` with rank ``src``'s, in place;
    returns ``tree``."""
    if not _group_up():
        return tree

    def bcast(x: torch.Tensor) -> torch.Tensor:
        buf = _staged(x)
        dist.broadcast(buf, src)
        if buf is not x:
            x.copy_(buf)
        return x

    return _map(tree, bcast)


def barrier() -> None:
    """Wait until every rank arrives (no-op without a process group)."""
    if _group_up():
        dist.barrier()
