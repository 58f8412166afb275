"""Which stage limits the bf16 trunk kernels: time each with a stage taken out.

    python -m othello_reinforcement_learning_test_tpu_torch.kernels.conv_stages

Needs a CUDA card and ``nvcc``. Builds variants of the shared conv body
``csrc/bf16_conv_sm90.cuh`` (``trunk_matmul9`` and ``trunk_wide``), each with
stages removed by the edits in :data:`STAGE_EDITS`, and times one trunk
forward of 20 convs at B=1024 (random bf16 activations, 20 layers of random
weights, the second conv of each block with its residual, as the trunk
launches them) with CUDA events, each variant twice in alternating order.
The variants' outputs are wrong by design; only their times are read:

- ``full``: the kernel as it is;
- ``no_loads``: no game after a warpgroup's first is loaded (its tile is
  reused), so neither the global loads nor the shared stores of the
  activation pipeline run;
- ``no_stores``: the epilogue writes nothing to global memory;
- ``no_loads_no_stores``: both;
- ``no_products``: no ``wgmma`` is issued (the fences, commits and waits stay).

Prints one JSON line per kernel and variant, then the card's name and power
limit. The kernels' own tests are in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

from . import build

HEADER = "bf16_conv_sm90.cuh"
# each edit: (text in the header, its replacement); every edit must apply once
STAGE_EDITS = {
    "loads": [
        ("    if (g_next < B) {  // in flight during this game's products",
         "    if (false) {"),
        ("    if (g_next < B) {  // the staging overwrote the halo\n      zero_halo(stage, t);",
         "    zero_halo(stage, t);\n    if (false) {"),
    ],
    "stores": [
        ("      *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);",
         "      if (o[0] == 0x7fc07fc0u && o[1] == 0x7fc07fc0u)  // never: two bf16 NaN pairs\n"
         "        *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);"),
    ],
    "products": [
        ("  for (int ks = 0; ks < C / 16; ++ks) wgmma_m64n64k16(d, a_desc(a_tap, ks), "
         "b_desc(b_tap, ks), ks);",
         "  for (int ks = 0; ks < 0; ++ks) wgmma_m64n64k16(d, a_desc(a_tap, ks), "
         "b_desc(b_tap, ks), ks);"),
        ("        for (int ks = 0; ks < C / 16; ++ks)\n          wgmma_m64n64k16(acc,",
         "        for (int ks = 0; ks < 0; ++ks)\n          wgmma_m64n64k16(acc,"),
    ],
}
VARIANTS = {"full": (), "no_loads": ("loads",), "no_stores": ("stores",),
            "no_loads_no_stores": ("loads", "stores"), "no_products": ("products",)}
ENTRY = """#include "{header}"
extern "C" int conv_m9(const void* in, const void* resid, void* out, const void* w,
                       const void* bias, int B, int is_conv1, void* stream) {{
  return bf16conv::launch<false, false>(in, resid, out, w, bias, B, is_conv1, stream);
}}
extern "C" int conv_wide(const void* in, const void* resid, void* out, const void* w,
                         const void* bias, int B, int is_conv1, void* stream) {{
  return bf16conv::launch<true, true>(in, resid, out, w, bias, B, is_conv1, stream);
}}
"""


def variant_header(text: str, stages) -> str:
    """The header with ``stages`` removed; raises if an edit does not apply
    exactly once (the header changed under it)."""
    for stage in stages:
        for old, new in STAGE_EDITS[stage]:
            if text.count(old) != 1:
                raise ValueError(f"stage edit {stage!r} does not apply to {HEADER}: {old[:60]!r}")
            text = text.replace(old, new)
    return text


def build_variant(name: str, stages) -> ctypes.CDLL:
    work = build.BUILD_DIR / "conv_stages"
    work.mkdir(parents=True, exist_ok=True)
    header = f"stages_{name}.cuh"
    (work / header).write_text(variant_header((build.CSRC_DIR / HEADER).read_text(), stages))
    src = work / f"stages_{name}.cu"
    src.write_text(ENTRY.format(header=header))
    lib = work / f"libstages_{name}.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conv_stages needs a CUDA card")
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build_variant(*kv), VARIANTS.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch, layers, C = 1024, 20, 128
    x = (torch.rand((batch, 8, 8, C), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    y, out = torch.empty_like(x), torch.empty_like(x)
    w9 = [(torch.randn((3, 3, C, C), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
          for _ in range(layers)]
    weights = {"conv_m9": w9,
               "conv_wide": [w.permute(2, 0, 1, 3).reshape(C, 9 * C).contiguous() for w in w9]}
    bias = [torch.randn(C, generator=gen, device="cuda") * 0.1 for _ in range(layers)]
    stream = torch.cuda.current_stream().cuda_stream

    def trunk(fn, ws):
        for i in range(0, layers, 2):
            h = x if i == 0 else out
            for j, (src, resid, dst) in enumerate(((h, None, y), (y, h, out))):
                rc = fn(src.data_ptr(), None if resid is None else resid.data_ptr(),
                        dst.data_ptr(), ws[i + j].data_ptr(), bias[i + j].data_ptr(), batch,
                        int(resid is not None), stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")

    def time_ms(fn, ws, reps=20):
        for _ in range(3):
            trunk(fn, ws)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            trunk(fn, ws)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for symbol, kernel in (("conv_m9", "trunk_matmul9"), ("conv_wide", "trunk_wide")):
        times = {name: [] for name in VARIANTS}
        for order in (list(VARIANTS), list(reversed(VARIANTS))):
            for name in order:
                fn = getattr(libs[name], symbol)
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                times[name].append(time_ms(fn, weights[symbol]))
        for name, ms in times.items():
            print(json.dumps({"kernel": kernel, "variant": name, "batch": batch,
                              "ms_per_forward": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
