"""The profilers' measurement: one part of the program timed on its own.

The port's counterpart of the JAX scripts' ``timed`` helper and their null
row. The JAX scripts chain R calls inside one jit to hide a fixed per-call
cost; the port runs eagerly, so each call of a part is timed directly:

- a warm-up call first, then one call with
  ``torch.cuda.set_sync_debug_mode("warn")`` that counts the host syncs
  (the warnings PyTorch raises for a synchronizing operation; a lower
  bound: a sync outside PyTorch's checks, such as an explicit
  ``torch.cuda.synchronize()``, is not seen);
- ``repeats`` x ``reps`` timed calls: the host clock around each call
  with ``torch.cuda.synchronize()`` after it (what the search's host loop
  pays), and CUDA events recorded on the stream just before and after the
  part alone (its stream span, which holds the device's gaps while the
  host enqueues). Each repeat gives the mean of its ``reps`` calls; the
  row reports the best repeat, as the JAX scripts do, with the median and
  the range;
- calls each alone under ``torch.profiler`` (device activity only)
  between two runs of marker kernels (``torch.cuda._sleep``, which no
  part launches), until ``PROFILE_PASSES`` passes are complete or
  ``PROFILE_SESSIONS`` sessions ran: the device operations ("launches":
  kernels, copies, fills), their summed device time (device-busy ms) and
  the top kernels of the fullest complete pass. A session loses a run of
  device records at its start: on an H100 two or three in a fresh
  process, 17 to 27 late in ``chip_smoke.py``, whose earlier phases load
  dozens of kernel libraries and profile often; now and then a session
  keeps none at all, or none after some point. The markers take the loss:
  a pass counts as complete when a marker survives on both sides of the
  call (and, for a part with device work, an operation of it between
  them), and after an incomplete one the next session's marker runs are
  longer (``PADS``).
  The row keeps every session's markers and operations (``passes``) and
  their number (``tries``); ``profile_complete`` is false when no pass was
  complete. Where no pass shows device time those fields say "not
  measured" and the event times stay;
- the trunk kernels' own launch counters over the timed calls.

``restore`` runs before every call, outside the timed window and outside
the profiled pass, so a part that writes its state in place (the tree's
expand and backup) times the same work every call.

The null row is the same harness around an empty part; each row's ``net``
figures subtract its best, as the JAX scripts do, beside the raw ones. On
the CPU only the host clock applies and the device fields are ``None``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch

from ..kernels.trunk_int8 import trunk_int8
from ..kernels.trunk_int8_dx3 import trunk_int8_dx3
from ..kernels.trunk_int8_dxcat import trunk_int8_dxcat
from ..kernels.trunk_int8_flat import trunk_int8_flat
from ..kernels.trunk_int8_m9 import trunk_int8_m9
from ..kernels.trunk_int8_patch import trunk_int8_patch
from ..kernels.trunk_matmul9 import trunk_matmul9
from ..kernels.trunk_wide import trunk_wide
from ..models.convert import from_jax_variables, init_train_variables
from ..models.resnet import OthelloResNet

# the wrappers whose launch counters every row reads
TRUNK_KERNELS = (trunk_int8_dx3, trunk_int8_dxcat, trunk_matmul9, trunk_wide, trunk_int8,
                 trunk_int8_m9, trunk_int8_patch, trunk_int8_flat)
NOT_MEASURED = "not measured"
TOP_KERNELS = 5
WARMUP = 1  # calls before a part is measured
PROFILE_PASSES = 2  # complete profiled passes wanted
PROFILE_SESSIONS = 8  # profiled sessions tried at most
# marker kernels on each side of a profiled call: the first session's, then
# one step longer after each incomplete session
PADS = (64, 256, 1024)
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
SYNC_WARNING = "called a synchronizing CUDA operation"


def initial_model(blocks: int, filters: int, dev: torch.device) -> OthelloResNet:
    """The trainer's initial weights at seed 0, in eval mode on ``dev``."""
    model = OthelloResNet(blocks, filters)
    model.load_state_dict(from_jax_variables(init_train_variables(blocks, filters, 0)))
    return model.to(dev).eval()


def device_record(dev: torch.device) -> Dict:
    """The device a profiler ran on; on the card also its ``nvidia-smi``
    name and power limit."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"device": f"cuda:{dev.index or 0} ({torch.cuda.get_device_name(dev)})",
            "nvidia_smi": smi[dev.index or 0]}


def _count_syncs(part: Callable[[], object]) -> int:
    """The synchronizing operations PyTorch reports during one call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            part()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def _session(part: Callable[[], object], pad: int) -> tuple:
    """One call under torch.profiler (device activity only) between two
    runs of ``pad`` marker kernels. Returns (wall ms, device operations of
    the call, markers recorded before it, after it)."""
    from torch.profiler import ProfilerActivity, profile

    def markers():
        for _ in range(pad):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        markers()
        t0 = time.perf_counter()
        part()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        markers()
    device = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marker = [MARKER in e.name for e in device]
    ops = [e for e, m in zip(device, marker) if not m]
    if not ops:
        return wall_ms, ops, len(device), len(device)
    return wall_ms, ops, marker.index(False), marker[::-1].index(False)


def _profiled(part: Callable[[], object], restore: Callable[[], None],
              top: Optional[int] = TOP_KERNELS, device_work: bool = True) -> Dict:
    """Profiled sessions (:func:`_session`) until PROFILE_PASSES are
    complete (a marker recorded on both sides of the call and, for a part
    with ``device_work``, an operation between them: with none the markers
    cannot tell the sides apart) or PROFILE_SESSIONS ran, the marker runs
    one step of PADS longer after each incomplete one: the complete pass with the most device operations
    (else the fullest pass, ``profile_complete`` false) gives the wall ms,
    device-busy ms, operations and the ``top`` kernels by device time
    (None: every kernel)."""
    passes = []
    step = 0
    while (sum(p["complete"] for p in passes) < PROFILE_PASSES
           and len(passes) < PROFILE_SESSIONS):
        pad = PADS[min(step, len(PADS) - 1)]
        restore()
        torch.cuda.synchronize()
        wall_ms, ops, before, after = _session(part, pad)
        ok = before > 0 and after > 0 and (bool(ops) or not device_work)
        passes.append({"wall_ms": wall_ms, "ops": ops, "pad": pad, "markers": [before, after],
                       "complete": ok})
        step += not ok
    complete = [p for p in passes if p["complete"]]
    best = max(complete or passes, key=lambda p: len(p["ops"]))
    by_name: Dict[str, List[float]] = {}
    for e in best["ops"]:
        count_us = by_name.setdefault(e.name, [0, 0.0])
        count_us[0] += 1
        count_us[1] += e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"profiled_wall_ms": best["wall_ms"],
            "device_busy_ms": sum(e.time_range.elapsed_us() for e in best["ops"]) / 1e3,
            "launches": len(best["ops"]), "profile_complete": bool(complete),
            "tries": len(passes),
            "passes": [{"launches": len(p["ops"]), "pad": p["pad"], "markers": p["markers"],
                        "complete": p["complete"]} for p in passes],
            "top": [[name[:60], us / 1e3, n] for name, (n, us) in ranked]}


def _spread(values: List[float]) -> Dict:
    return {"best": min(values), "median": statistics.median(values),
            "range": [min(values), max(values)]}


class Harness:
    """Times parts on one device (see the module docstring); ``rows`` keeps
    every row in order, the null row first once :meth:`null` ran. ``top``:
    the kernels by device time a row lists (None: every kernel)."""

    def __init__(self, dev: torch.device, reps: int, repeats: int, unit: str = "ms",
                 top: Optional[int] = TOP_KERNELS):
        if reps < 1 or repeats < 1:
            raise ValueError(f"reps and repeats must be >= 1 (got {reps}, {repeats})")
        self.dev, self.reps, self.repeats, self.top = dev, reps, repeats, top
        self.on_card = dev.type == "cuda"
        self.scale, self.unit = {"ms": (1.0, "ms"), "us": (1e3, "us")}[unit]
        self.null_ms: Optional[float] = None
        self.rows: List[Dict] = []

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def null(self) -> Dict:
        """The null row: the harness around an empty part."""
        row = self.time("null (per-call overhead)", lambda: None, device_work=False)
        self.null_ms = row["wall_ms"]["best"]
        return row

    def time(self, name: str, part: Callable[[], object],
             restore: Optional[Callable[[], None]] = None, forwards: int = 0,
             device_work: bool = True, **fields) -> Dict:
        """Time ``part`` (see the module docstring) and print its row.
        ``forwards``: network forwards a call, beside the trunk launches;
        ``device_work=False``: a part that runs nothing on the device (its
        busy time is 0, not unmeasured, when the profiler sees nothing);
        ``fields`` go into the row as they are."""
        restore = restore or (lambda: None)
        for _ in range(WARMUP):
            restore()
            self._sync()
            part()
        self._sync()
        row: Dict = {"name": name, "calls": self.reps * self.repeats, "forwards": forwards}
        if self.on_card:
            restore()
            self._sync()
            row["syncs"] = _count_syncs(part)
        for k in TRUNK_KERNELS:
            k.launches = 0
        walls, spans = [], []
        for _ in range(self.repeats):
            wall = span = 0.0
            for _ in range(self.reps):
                restore()
                self._sync()
                if self.on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    start.record()
                    part()
                    end.record()
                    torch.cuda.synchronize(self.dev)
                    wall += time.perf_counter() - t0
                    span += start.elapsed_time(end)
                else:
                    t0 = time.perf_counter()
                    part()
                    wall += time.perf_counter() - t0
            walls.append(wall * 1e3 / self.reps)
            spans.append(span / self.reps)
        calls = self.reps * self.repeats
        row["kernel_launches"] = {k.__name__: k.launches / calls for k in TRUNK_KERNELS
                                  if k.launches}
        row["wall_ms"] = _spread(walls)
        if self.null_ms is not None:
            row["wall_ms_net"] = {key: v - self.null_ms for key, v in row["wall_ms"].items()
                                  if key != "range"}
        if self.on_card:
            row["event_ms"] = _spread(spans)
            prof = _profiled(part, restore, self.top, device_work)
            if prof["device_busy_ms"] == 0 and device_work:
                prof.update(device_busy_ms=NOT_MEASURED, launches=NOT_MEASURED)
            row.update(prof)
        else:
            row.update(syncs=None, event_ms=None, profiled_wall_ms=None, device_busy_ms=None,
                       launches=None, profile_complete=None, tries=None, passes=None,
                       top=None)
        restore()
        row.update(fields)
        self.rows.append(row)
        print(self.format(row), flush=True)
        return row

    def format(self, row: Dict) -> str:
        """A row as the JAX scripts print it (net, then raw), with the
        median, range and the device's figures."""
        s, u = self.scale, self.unit
        w = row["wall_ms"]
        net = row.get("wall_ms_net", w)["best"]
        text = (f"{row['name']:34s}: {net * s:9.3f} {u}   (raw {w['best'] * s:.3f}, median "
                f"{w['median'] * s:.3f}, range {w['range'][0] * s:.3f}-{w['range'][1] * s:.3f}")
        if self.on_card:
            busy = row["device_busy_ms"]
            busy = f"{busy * s:.3f} {u}" if isinstance(busy, float) else busy
            text += (f"; events {row['event_ms']['best'] * s:.3f} {u}; device busy {busy}, "
                     f"{row['launches']} launches, {row['syncs']} syncs, {row['tries']} profiled "
                     f"sessions")
        return text + ")"


def finish(result: Dict) -> int:
    """Print the profiler's JSON object as its last line."""
    print(json.dumps(result), flush=True)
    return 0
