"""Which stage limits the trunk kernels: time each with a stage taken out.

    python -m othello_reinforcement_learning_test_tpu_torch.kernels.conv_stages [--body bf16|int8|dxcat]

Needs a CUDA card and ``nvcc``. Builds variants of a shared conv body, each
with stages removed by text edits of its header, and times one trunk
forward of 20 convs at B=1024 (20 layers of random weights, the second conv
of each block with its residual, as the trunk launches them) with CUDA
events, each variant twice in alternating order. The variants' outputs are
wrong by design; only their times are read. The bodies (``--body``, all by
default):

- ``bf16``: ``csrc/bf16_conv_sm90.cuh`` (``trunk_matmul9`` and
  ``trunk_wide``) on random bf16 activations;
- ``int8``: ``csrc/int8_conv_sm90.cuh`` (``trunk_int8_dx3``, and
  ``trunk_int8`` with ``stage_bf16``) on random f32 activations, after the
  trunk's pre-pass, at their default blocks of 64 and 16 games;
- ``dxcat``: ``csrc/int8_trunk_sm90.cuh`` (``trunk_int8_dxcat``, the whole
  trunk in one cooperative launch) at B=64 and 40, the gated iteration's
  batches, and at 1024, block of 64 games, on random bf16 input; beside its
  variants, ``per_conv`` (the same kernel launched once a conv from the
  same C call, no grid barrier) and ``int8_dx3`` (the int8 body as its
  wrapper launches it, one launch and one host call a conv).

The variants:

- ``full``: the kernel as it is;
- ``no_loads``: bf16: no game after a warpgroup's first is loaded (its
  tile is reused), so neither the global loads nor the shared stores of
  the activation pipeline run; int8 and dxcat: the producer stages only
  its first game (dxcat: of the launch) and quantizes it again for every
  later game (and conv);
- ``no_quantize`` (int8 only): the loads run, but each float4's first
  float's bits are written to the tile in place of its four int8 codes;
- ``no_stores`` (bf16, int8): the epilogue writes nothing to global memory;
- ``no_loads_no_stores`` (bf16, int8): both;
- ``no_products``: no ``wgmma`` is issued (the fences, commits and waits stay);
- ``no_barrier`` (dxcat only): thread 0 of a CTA arrives at the grid barrier
  and goes on without waiting for the others.

Prints one JSON line per kernel and variant, then the card's name and power
limit. The kernels' own tests are in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

from . import build

HEADER = "bf16_conv_sm90.cuh"
# each edit: (text in the header, its replacement); every edit must apply once
STAGE_EDITS = {
    "loads": [
        ("    if (g_next < B) {  // in flight during this game's products",
         "    if (false) {"),
        ("    if (g_next < B) {  // the staging overwrote the halo\n      zero_halo<G>(stage, t);",
         "    zero_halo<G>(stage, t);\n    if (false) {"),
    ],
    "stores": [
        ("      *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);",
         "      if (o[0] == 0x7fc07fc0u && o[1] == 0x7fc07fc0u)  // never: two bf16 NaN pairs\n"
         "        *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);"),
    ],
    "products": [
        ("  for (int ks = 0; ks < G::C / 16; ++ks)\n    wgmma_bf16(d,",
         "  for (int ks = 0; ks < 0; ++ks)\n    wgmma_bf16(d,"),
        ("        for (int ks = 0; ks < C / 16; ++ks)\n          wgmma_bf16(acc,",
         "        for (int ks = 0; ks < 0; ++ks)\n          wgmma_bf16(acc,"),
    ],
}
VARIANTS = {"full": (), "no_loads": ("loads",), "no_stores": ("stores",),
            "no_loads_no_stores": ("loads", "stores"), "no_products": ("products",)}
ENTRY = """#include "{header}"
extern "C" int conv_m9(const void* in, const void* resid, void* out, const void* w,
                       const void* bias, int B, int is_conv1, void* stream) {{
  return bf16conv::launch<8, 128, false, false>(in, resid, out, w, bias, B, is_conv1, stream);
}}
extern "C" int conv_wide(const void* in, const void* resid, void* out, const void* w,
                         const void* bias, int B, int is_conv1, void* stream) {{
  return bf16conv::launch<8, 128, true, true>(in, resid, out, w, bias, B, is_conv1, stream);
}}
"""

INT8_HEADER = "int8_conv_sm90.cuh"
NEVER = "0x7fc00001u"  # a NaN's bits that no output has
INT8_STAGE_EDITS = {
    "loads": [
        ("        mbar_wait(sbars + hh * 8, j & 1);", "        if (j == 0) mbar_wait(sbars + hh * 8, 0);"),
        ("        if (t == 0 && g + step < B) stage_half<G>(", "        if (false) stage_half<G>("),
    ],
    "quantize": [
        ("    w[i] = pack4(quantize1(v[i].x, y, near), quantize1(v[i].y, y, near),\n"
         "                 quantize1(v[i].z, y, near), quantize1(v[i].w, y, near));",
         "    w[i] = __float_as_uint(v[i].x);"),
    ],
    "stores": [
        ("        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + off) = "
         "__floats2bfloat162_rn(z0, z1);",
         f"        if (__float_as_uint(z0) == {NEVER} && __float_as_uint(z1) == {NEVER})\n"
         "          *reinterpret_cast<__nv_bfloat162*>(out_bf16 + off) = "
         "__floats2bfloat162_rn(z0, z1);"),
        ("        *reinterpret_cast<float2*>(out + off) = make_float2(z0, z1);",
         f"        if (__float_as_uint(z0) == {NEVER} && __float_as_uint(z1) == {NEVER})\n"
         "          *reinterpret_cast<float2*>(out + off) = make_float2(z0, z1);"),
    ],
    "products": [
        ("  for (int ks = 0; ks < G::KP / 32; ++ks)\n    wgmma_s8(d,",
         "  for (int ks = 0; ks < 0; ++ks)\n    wgmma_s8(d,"),
        ("        for (int ks = 0; ks < G::KP / 32; ++ks)\n          wgmma_s8(acc,",
         "        for (int ks = 0; ks < 0; ++ks)\n          wgmma_s8(acc,"),
    ],
}
INT8_VARIANTS = {"full": (), "no_loads": ("loads",), "no_quantize": ("quantize",),
                 "no_stores": ("stores",), "no_loads_no_stores": ("loads", "stores"),
                 "no_products": ("products",)}
INT8_ENTRY = """#include "{header}"
extern "C" int prepass(const void* x, void* xf, void* amax, int B, int bg, int num_layers,
                       void* stream) {{
  return int8conv::prepass<8, 128>(x, xf, amax, B, bg, num_layers, stream);
}}
extern "C" int conv(const void* in, const void* resid, void* out, void* out_bf16,
                    const void* w, const void* wscale, const void* bias, void* amax, int layer,
                    int num_layers, int B, int bg, int is_conv1, int is_last, int stage_bf16,
                    void* stream) {{
  return (stage_bf16 ? int8conv::launch<8, 128, true> : int8conv::launch<8, 128, false>)(
      in, resid, out, out_bf16, w, wscale, bias, amax, layer, num_layers, B, bg, is_conv1,
      is_last, stream);
}}
"""
TRUNK_HEADER = "int8_trunk_sm90.cuh"
TRUNK_STAGE_EDITS = {
    "barrier": [("    } while (v < target);", "    } while (false);")],
    "loads": [
        ("      if (t == 0) {\n        stage_half<T>(staging, sbars, in, slot, 0);",
         "      if (t == 0 && jj == 0) {\n        stage_half<T>(staging, sbars, in, slot, 0);"),
        ("          mbar_wait(sbars + hh * 8, j & 1);",
         "          if (j == 0) mbar_wait(sbars + hh * 8, 0);"),
        ("          if (t == 0 && i + 1 < n) stage_half<T>(", "          if (false) stage_half<T>("),
    ],
    "products": [
        ("    for (int ks = 0; ks < T::KP / 32; ++ks)\n      wgmma_s8(acc,",
         "    for (int ks = 0; ks < 0; ++ks)\n      wgmma_s8(acc,"),
    ],
}
TRUNK_VARIANTS = {"full": (), "no_barrier": ("barrier",), "no_loads": ("loads",),
                  "no_products": ("products",)}
TRUNK_ENTRY = """#include "{header}"
extern "C" int trunk(const void* x, void* xf, void* yf, void* out, const void* w,
                     const void* wscale, const void* bias, void* scratch, int L, int B, int bg,
                     int per_launch, void* stream) {{
  return int8trunk::forward<8, 128>(x, xf, yf, out, w, wscale, bias, scratch, L, B, bg,
                                    per_launch, stream);
}}
"""
# body: (header, its stage edits, its variants, the entry points' source)
BODIES = {"bf16": (HEADER, STAGE_EDITS, VARIANTS, ENTRY),
          "int8": (INT8_HEADER, INT8_STAGE_EDITS, INT8_VARIANTS, INT8_ENTRY),
          "dxcat": (TRUNK_HEADER, TRUNK_STAGE_EDITS, TRUNK_VARIANTS, TRUNK_ENTRY)}
BATCH, LAYERS, C = 1024, 20, 128
DXCAT_BATCHES = (64, 40, 1024)


def variant_header(text: str, stages, edits=STAGE_EDITS, header: str = HEADER) -> str:
    """``header``'s text with ``stages`` removed by ``edits``; raises if an
    edit does not apply exactly once (the header changed under it)."""
    for stage in stages:
        for old, new in edits[stage]:
            if text.count(old) != 1:
                raise ValueError(f"stage edit {stage!r} does not apply to {header}: {old[:60]!r}")
            text = text.replace(old, new)
    return text


def build_variant(body: str, name: str, stages) -> ctypes.CDLL:
    header, edits, _, entry = BODIES[body]
    work = build.BUILD_DIR / "conv_stages"
    work.mkdir(parents=True, exist_ok=True)
    variant = f"stages_{body}_{name}"
    (work / f"{variant}.cuh").write_text(
        variant_header((build.CSRC_DIR / header).read_text(), stages, edits, header))
    src = work / f"{variant}.cu"
    src.write_text(entry.format(header=f"{variant}.cuh"))
    lib = work / f"lib{variant}.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def time_ms(forward, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        forward()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        forward()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_forwards(libs: dict) -> dict:
    """{(kernel, variant): one trunk forward through that variant's library}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.rand((BATCH, 8, 8, C), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    y, out = torch.empty_like(x), torch.empty_like(x)
    w9 = [(torch.randn((3, 3, C, C), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
          for _ in range(LAYERS)]
    weights = {"conv_m9": w9,
               "conv_wide": [w.permute(2, 0, 1, 3).reshape(C, 9 * C).contiguous() for w in w9]}
    bias = [torch.randn(C, generator=gen, device="cuda") * 0.1 for _ in range(LAYERS)]
    stream = torch.cuda.current_stream().cuda_stream

    def trunk(fn, ws):
        for i in range(0, LAYERS, 2):
            h = x if i == 0 else out
            for j, (src, resid, dst) in enumerate(((h, None, y), (y, h, out))):
                rc = fn(src.data_ptr(), None if resid is None else resid.data_ptr(),
                        dst.data_ptr(), ws[i + j].data_ptr(), bias[i + j].data_ptr(), BATCH,
                        int(resid is not None), stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")

    forwards = {}
    for symbol, kernel in (("conv_m9", "trunk_matmul9"), ("conv_wide", "trunk_wide")):
        for name, lib in libs.items():
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            forwards[kernel, name] = lambda fn=fn, ws=weights[symbol]: trunk(fn, ws)
    return forwards


def int8_forwards(libs: dict) -> dict:
    """{(kernel, variant): one trunk forward through that variant's library},
    launched as the int8 wrappers launch it."""
    import torch

    from .trunk_int8_dx3 import launch_int8_trunk

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.rand((BATCH, 8, 8, C), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    w = torch.randint(-127, 128, (LAYERS, 9, C, C), generator=gen, device="cuda",
                      dtype=torch.int8)
    w_scale = torch.rand((LAYERS, C), generator=gen, device="cuda") * 1e-3
    bias = torch.randn((LAYERS, C), generator=gen, device="cuda") * 0.1

    class Launches:  # launch_int8_trunk counts its launches here
        launches = 0

    forwards = {}
    for kernel, block_games, stage_bf16 in (("trunk_int8_dx3", 64, 0), ("trunk_int8_bf16", 16, 1)):
        for name, lib in libs.items():
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.prepass.argtypes, lib.prepass.restype = [p, p, p, i, i, i, p], i
            lib.conv.argtypes, lib.conv.restype = [p] * 8 + [i] * 7 + [p], i
            forwards[kernel, name] = (
                lambda lib=lib, bgames=block_games, st=stage_bf16: launch_int8_trunk(
                    Launches, lib.prepass, lib.conv, x, w, w_scale, bias, bgames, st))
    return forwards


def dxcat_forwards(libs: dict) -> dict:
    """{((kernel, batch), variant): one trunk forward}: the one-launch trunk's
    variants, ``per_conv`` (the full build, one launch a conv) and
    ``int8_dx3`` (its wrapper on the same K-major weights)."""
    import torch

    from .trunk_int8_dx3 import block_size, trunk_int8_dx3

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randint(-127, 128, (LAYERS, 9, C, C), generator=gen, device="cuda",
                      dtype=torch.int8)
    w_scale = torch.rand((LAYERS, C), generator=gen, device="cuda") * 1e-3
    bias = torch.randn((LAYERS, C), generator=gen, device="cuda") * 0.1
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.trunk.argtypes, lib.trunk.restype = [p] * 8 + [i] * 4 + [p], i

    def trunk(lib, x, buf, out, bg, per_launch):
        act = x.numel()
        rc = lib.trunk(x.data_ptr(), buf.data_ptr(), buf[act:].data_ptr(), out.data_ptr(),
                       w.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                       buf[2 * act:].data_ptr(), LAYERS, x.shape[0], bg, per_launch, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")

    forwards = {}
    for batch in DXCAT_BATCHES:
        x = (torch.rand((batch, 8, 8, C), generator=gen, device="cuda") * 2).to(torch.bfloat16)
        bg = block_size(batch, 64)
        buf = torch.empty(2 * x.numel() + LAYERS * (batch // bg + 1), device="cuda")
        out = torch.empty_like(x)
        key = ("trunk_int8_dxcat", batch)
        for name, lib in libs.items():
            forwards[key, name] = (lambda lib=lib, x=x, buf=buf, out=out, bg=bg:
                                   trunk(lib, x, buf, out, bg, LAYERS))
        forwards[key, "per_conv"] = (lambda lib=libs["full"], x=x, buf=buf, out=out, bg=bg:
                                     trunk(lib, x, buf, out, bg, 1))
        forwards[key, "int8_dx3"] = lambda x=x: trunk_int8_dx3(x, w, w_scale, bias, 64)
    return forwards


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--body", choices=sorted(BODIES), action="append",
                        help="conv body to measure (default: both)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_stages needs a CUDA card")
    from concurrent.futures import ThreadPoolExecutor

    bodies = args.body or sorted(BODIES)
    jobs = [(body, name, stages) for body in bodies for name, stages in BODIES[body][2].items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build_variant(*job), jobs))
    for body in bodies:
        libs = {name: lib for (b, name, _), lib in zip(jobs, built) if b == body}
        forwards = {"bf16": bf16_forwards, "int8": int8_forwards,
                    "dxcat": dxcat_forwards}[body](libs)
        for kernel in dict.fromkeys(k for k, _ in forwards):
            variants = [name for k, name in forwards if k == kernel]
            times = {name: [] for name in variants}
            for order in (variants, variants[::-1]):
                for name in order:
                    times[name].append(time_ms(forwards[kernel, name]))
            name_batch = kernel if isinstance(kernel, tuple) else (kernel, BATCH)
            for name, ms in times.items():
                print(json.dumps({"kernel": name_batch[0], "variant": name,
                                  "batch": name_batch[1], "ms_per_forward": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
