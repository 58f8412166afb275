"""Split the fused network forward into stem, trunk and heads on one device.

    python -m othello_reinforcement_learning_test_tpu_torch.profilers.profile_forward_parts \\
        [--batch 1024] [--reps 64] [--kernels dx3 dxcat] [--bgs 16 32 64] [--device cpu]

Port of the JAX package's ``scripts/profile_forward_parts.py`` (which stays
JAX-only): the same flags and defaults, with ``--device`` (CUDA unless
``cpu`` is asked for; no fallback) in place of ``--platform``, and
``--blocks`` and ``--filters`` added. On the trainer's initial weights at
seed 0 it times, with ``profilers/common.py``'s harness, each part of
``models/fused_resnet.py::FusedInference``:

- the stem (``FusedInference.stem``: bf16 conv, BatchNorm, ReLU);
- the weight fold and quantization (``quantize_trunk``), which the port
  hoists into ``FusedInference.__init__``: the JAX row "quantize_trunk (if
  unhoisted)";
- the int8 trunk for each of ``--kernels`` at each of ``--bgs`` games a
  scale block (``FusedInference.trunk`` of ``int8_<kernel>`` built at
  that block size) on a normal bf16 input;
- the heads (``FusedInference.heads``);
- the full forward of each of ``--full-variants`` and of the plain bf16
  forward (``apply_eval``).

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from ..models.fused_resnet import PORTED_VARIANTS, FusedInference
from ..models.quantized import quantize_trunk
from ..train.trainer import apply_eval
from ..utils.device import resolve_device
from .common import Harness, device_record, finish, initial_model

KERNELS = ("dx3", "dxcat")  # --kernels: the FusedInference variant int8_<kernel>


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=64, help="calls a repeat")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--bgs", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    ap.add_argument("--full-variants", nargs="+", choices=PORTED_VARIANTS, default=["int8_dx3"])
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--filters", type=int, default=128)
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    return ap.parse_args(argv)


@torch.no_grad()
def run(argv: Optional[List[str]] = None) -> Dict:
    """Print the rows and return the JSON object."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    B, C = args.batch, args.filters
    model = initial_model(args.blocks, C, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((B, 8, 8, 3), generator=gen, device=dev)
    h0 = torch.randn((B, 8, 8, C), generator=gen, device=dev).to(torch.bfloat16)
    fused = {v: FusedInference(model, v)
             for v in dict.fromkeys(["int8_dx3"] + args.full_variants)}

    h = Harness(dev, args.reps, args.repeats)
    h.null()
    stem = h.time("stem (conv 3->C + BN)", lambda: fused["int8_dx3"].stem(x0))
    quant = h.time("quantize_trunk (hoisted)", lambda: quantize_trunk(model))
    for kernel in args.kernels:
        for bg in args.bgs:
            trunk = FusedInference(model, f"int8_{kernel}", block_games=bg).trunk
            h.time(f"trunk int8_{kernel} bg={bg}", lambda trunk=trunk: trunk(h0), forwards=1,
                   kernel=kernel, block_games=bg)
    heads = h.time("heads (1x1 convs + dense)", lambda: fused["int8_dx3"].heads(h0))
    for v in args.full_variants:
        h.time(f"full fused {v}", lambda v=v: fused[v](x0), forwards=1, variant=v)
    plain = apply_eval(model)
    h.time("full plain bf16", lambda: plain(x0), forwards=1, variant="xla")

    def best(row):
        return row["wall_ms_net"]["best"]

    print(f"\nB={B}, {args.reps} calls a repeat, best of {args.repeats}; stem={best(stem):.3f} "
          f"heads={best(heads):.3f} quant={best(quant):.3f} ms")
    return {"profiler": "profile_forward_parts", "batch": B, "reps": args.reps,
            "repeats": args.repeats, "model": f"{args.blocks}x{C}", **device_record(dev),
            "rows": h.rows}


def main(argv: Optional[List[str]] = None) -> int:
    return finish(run(argv))


if __name__ == "__main__":
    sys.exit(main())
