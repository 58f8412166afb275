"""A network's weights: loaded from a file of the checkout, or made on the
device from the seed.

Both give a state dict of the upstream layout (``conv_block``,
``res_blocks.{i}``, ``policy_head``, ``value_head``), float32, which the
program and the reference are each handed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .spec import ROOT


def layout(blocks: int, filters: int, hidden: int, side: int = 8) -> List[Tuple[str, tuple]]:
    """(key, shape) of every tensor of the network, BatchNorm counters aside."""
    ss = side * side
    bn = lambda p, n: [(f"{p}.{k}", (n,)) for k in  # noqa: E731
                       ("weight", "bias", "running_mean", "running_var")]
    out = [("conv_block.conv.weight", (filters, 3, 3, 3)), *bn("conv_block.bn", filters)]
    for i in range(blocks):
        for j in (1, 2):
            out += [(f"res_blocks.{i}.conv{j}.weight", (filters, filters, 3, 3)),
                    *bn(f"res_blocks.{i}.bn{j}", filters)]
    out += [("policy_head.conv.weight", (2, filters, 1, 1)), *bn("policy_head.bn", 2),
            ("policy_head.fc.weight", (ss + 1, 2 * ss)), ("policy_head.fc.bias", (ss + 1,)),
            ("value_head.conv.weight", (1, filters, 1, 1)), *bn("value_head.bn", 1),
            ("value_head.fc1.weight", (hidden, ss)), ("value_head.fc1.bias", (hidden,)),
            ("value_head.fc2.weight", (1, hidden)), ("value_head.fc2.bias", (1,))]
    return out


def seeded(blocks: int, filters: int, hidden: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights drawn on ``device`` from ``seed`` in two calls: He-normal
    convolutions, dense layers of variance 1 / fan-in, BatchNorm scales in
    [0.25, 0.75] and variances in [0.75, 1.25], biases and means of spread
    0.05. So each residual branch adds about a quarter of the tower's
    variance, and the priors are neither flat nor one-hot."""
    shapes = layout(blocks, filters, hidden)
    sizes = [torch.Size(s).numel() for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device).split(sizes)
    uniform = torch.rand(sum(sizes), generator=gen, device=device).split(sizes)
    sd = {}
    for (key, shape), z, u in zip(shapes, normal, uniform):
        z, u = z.view(shape), u.view(shape)
        if key.endswith(".weight") and len(shape) > 1:
            fan_in = torch.Size(shape[1:]).numel()
            sd[key] = z * ((2.0 if "conv" in key else 1.0) / fan_in) ** 0.5
        elif key.endswith(".weight"):
            sd[key] = 0.25 + 0.5 * u
        elif key.endswith(".running_var"):
            sd[key] = 0.75 + 0.5 * u
        else:
            sd[key] = 0.05 * z
    for key, _ in shapes:
        if key.endswith(".running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = torch.zeros(
                (), dtype=torch.int64, device=device)
    return sd


def load(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights: its ``weights.file`` (a torch file of the
    checkout; ``weights.key`` the state dict in it), else seeded."""
    spec = config["weights"]
    if "file" in spec:
        data = torch.load(ROOT / spec["file"], map_location=device, weights_only=True)
        return data[spec["key"]] if spec.get("key") else data
    return seeded(config["num_blocks"], config["num_filters"], config["value_hidden"], seed,
                  device)
