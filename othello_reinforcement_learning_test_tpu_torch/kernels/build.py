"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled
for Hopper (``sm_90a``) into a shared library under the package's
git-ignored ``_build/`` directory on first use. The library's file name
carries a hash of the source, the headers ``csrc/*.cuh`` and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.

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
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source, csrc/<name>.cu, in the order chip_smoke.py reports them
SOURCES = ("trunk_int8_dx3", "trunk_matmul9", "trunk_int8", "random_step", "trunk_wide",
           "trunk_int8_m9", "trunk_int8_patch", "trunk_int8_flat", "trunk_int8_dxcat")
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


@functools.cache
def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source,
    these headers and these flags already exists."""
    src = CSRC_DIR / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name).path))
