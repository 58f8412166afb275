"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled
for Hopper (``sm_90a``) into a shared library under the package's
git-ignored ``_build/`` directory on first use. The library's file name
carries a hash of the source, the headers ``csrc/*.cuh`` and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.

The trunk sources are templates on the board side S and the channel count
C: each library is one shape, built at its first use with ``-DTRUNK_S`` and
``-DTRUNK_C`` (in its file name and hash), so a process builds only the
shapes it runs. :func:`check_trunk_shape` states the shapes they take: every
width from 1 to 256, a library being built at the width rounded up to a
multiple of 16 (:func:`padded_channels`; the wrappers add zero channels).

``-fmad=false`` keeps every float multiply and add separately rounded, as
the plain PyTorch versions compute them, so kernel and plain version can
agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source, csrc/<name>.cu, in the order chip_smoke.py reports them
SOURCES = ("trunk_int8_dx3", "trunk_matmul9", "trunk_int8", "random_step", "trunk_wide",
           "trunk_int8_m9", "trunk_int8_patch", "trunk_int8_flat", "trunk_int8_dxcat",
           "leaf_step")
# the sources that are not trunks, built without a shape
UNSHAPED = ("random_step", "leaf_step")
# the trunks' shapes: every board side the engine takes, and channel counts
# up to 256 (past 128 the kernels stream a layer's weights through shared
# memory; past 256 an int8 wgmma's N, one consumer's 128 channels beside
# the other's, and the ring's tiles run out: ROADMAP.md section 5.3); the
# libraries are built at multiples of CHANNEL_STEP
BOARD_SIDES = (4, 6, 8)
CHANNEL_STEP, MAX_CHANNELS = 16, 256
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


class Built(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # nvcc's output (ptxas register and shared-memory report)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME, put nvcc on PATH, or install the "
        "CUDA toolkit under /usr/local/cuda")


def check_trunk_shape(S: int, C: int) -> None:
    """Raise ``ValueError`` unless the CUDA trunk kernels take S x S boards
    of C channels: S in :data:`BOARD_SIDES`, 1 <= C <= :data:`MAX_CHANNELS`."""
    if S not in BOARD_SIDES or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(
            f"the CUDA trunk kernels take board sides {', '.join(map(str, BOARD_SIDES))} and "
            f"channel counts from 1 to {MAX_CHANNELS}; got S={S} C={C}")


def padded_channels(C: int) -> int:
    """The width a library is built at: C rounded up to a multiple of
    :data:`CHANNEL_STEP` (the wrappers pad the trunk with zero channels)."""
    return -(-C // CHANNEL_STEP) * CHANNEL_STEP


def trunk_shape(x) -> Tuple[int, int]:
    """(S, padded C) of a trunk input (B, S, S, C): the shape of its library,
    after :func:`check_trunk_shape`."""
    S, C = int(x.shape[2]), int(x.shape[3])
    check_trunk_shape(S, C)
    return S, padded_channels(C)


@functools.cache
def build(name: str, shape: Optional[Tuple[int, int]] = None) -> Built:
    """Compile ``csrc/<name>.cu`` (a trunk at ``shape``, (S, C), built at
    (S, :func:`padded_channels` (C))) unless a library for this exact
    source, these headers, flags and shape already exists."""
    if (shape is None) != (name in UNSHAPED):
        raise ValueError(f"{name} is built {'without' if name in UNSHAPED else 'with'} a shape")
    if shape is not None:
        check_trunk_shape(*shape)
        shape = (shape[0], padded_channels(shape[1]))
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS if shape is None else (*NVCC_FLAGS, f"-DTRUNK_S={shape[0]}",
                                               f"-DTRUNK_C={shape[1]}")
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    tag = "" if shape is None else f"-s{shape[0]}c{shape[1]}"
    out = BUILD_DIR / f"lib{name}{tag}-{digest}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never sees a partial file
    return Built(out, seconds, log)


@functools.cache
def load(name: str, shape: Optional[Tuple[int, int]] = None) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, shape).path))
