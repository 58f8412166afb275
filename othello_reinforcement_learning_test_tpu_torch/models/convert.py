"""Carry flax-layout weights into the port's :class:`OthelloResNet`.

The JAX package stores the network as a flax tree ``{"params",
"batch_stats"}``; ``jax.tree.map(np.asarray, variables)`` turns it into
nested dicts of numpy arrays, which is what :func:`from_jax_variables`
takes. No jax is needed here.

Layout conversion (the same as ``models/torch_bridge.py`` of the JAX
package, copied rather than imported):

- conv kernels: flax HWIO ``(kh, kw, cin, cout)`` -> torch OIHW;
- dense kernels: flax ``(in, out)`` -> ``nn.Linear`` ``(out, in)``;
- BatchNorm: ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_*``;
- the policy FC flattens a 2-channel map: flax flattens NHWC (input row
  ``(h*S+w)*2 + c``), the port flattens NCHW (column ``c*S*S + h*S + w``),
  so its columns are permuted (:func:`policy_fc_perm`). The value FC
  flattens one channel, where both orders agree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def policy_fc_perm(board_size: int) -> np.ndarray:
    """``perm[t] = f``: port column ``t = c*S*S + h*S + w`` reads flax Dense
    input row ``f = (h*S + w)*2 + c``."""
    ss = board_size * board_size
    t = np.arange(2 * ss)
    c, hw = t // ss, t % ss
    return hw * 2 + c


def from_jax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax ``{params, batch_stats}`` (numpy leaves) -> port state dict."""
    params = variables["params"]
    stats = variables["batch_stats"]

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def conv_w(p) -> torch.Tensor:
        return t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))

    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix: str, p: Dict, s: Dict):
        sd[f"{prefix}.weight"] = t(p["scale"])
        sd[f"{prefix}.bias"] = t(p["bias"])
        sd[f"{prefix}.running_mean"] = t(s["mean"])
        sd[f"{prefix}.running_var"] = t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    sd["conv_block.conv.weight"] = conv_w(params["Conv_0"])
    bn("conv_block.bn", params["BatchNorm_0"], stats["BatchNorm_0"])

    num_blocks = sum(1 for k in params if k.startswith("ResBlock_"))
    for i in range(num_blocks):
        blk, blk_s = params[f"ResBlock_{i}"], stats[f"ResBlock_{i}"]
        sd[f"res_blocks.{i}.conv1.weight"] = conv_w(blk["Conv_0"])
        sd[f"res_blocks.{i}.conv2.weight"] = conv_w(blk["Conv_1"])
        bn(f"res_blocks.{i}.bn1", blk["BatchNorm_0"], blk_s["BatchNorm_0"])
        bn(f"res_blocks.{i}.bn2", blk["BatchNorm_1"], blk_s["BatchNorm_1"])

    sd["policy_head.conv.weight"] = conv_w(params["Conv_1"])
    bn("policy_head.bn", params["BatchNorm_1"], stats["BatchNorm_1"])
    fc_k = np.asarray(params["Dense_0"]["kernel"], dtype=np.float32)
    board_size = int(round(np.sqrt(fc_k.shape[0] // 2)))
    sd["policy_head.fc.weight"] = t(fc_k.T[:, policy_fc_perm(board_size)])
    sd["policy_head.fc.bias"] = t(params["Dense_0"]["bias"])

    sd["value_head.conv.weight"] = conv_w(params["Conv_2"])
    bn("value_head.bn", params["BatchNorm_2"], stats["BatchNorm_2"])
    sd["value_head.fc1.weight"] = t(np.asarray(params["Dense_1"]["kernel"]).T)
    sd["value_head.fc1.bias"] = t(params["Dense_1"]["bias"])
    sd["value_head.fc2.weight"] = t(np.asarray(params["Dense_2"]["kernel"]).T)
    sd["value_head.fc2.bias"] = t(params["Dense_2"]["bias"])
    return sd


def init_numpy_variables(num_blocks: int, num_filters: int, seed: int,
                         board_size: int = 8, value_hidden: int = 256) -> Dict:
    """A flax-shaped ``{params, batch_stats}`` tree of float32 numpy arrays,
    made from a numpy seed.

    Conv and dense kernels are He-normal, so activations keep their scale
    through the tower; BatchNorm gets non-trivial scales, shifts and
    running statistics, so folding it into the convs is exercised.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def conv(kh, cin, cout):
        std = np.sqrt(2.0 / (kh * kh * cin))
        return {"kernel": (rng.standard_normal((kh, kh, cin, cout)) * std).astype(f32)}

    def dense(n_in, n_out):
        std = np.sqrt(2.0 / n_in)
        return {"kernel": (rng.standard_normal((n_in, n_out)) * std).astype(f32),
                "bias": (rng.standard_normal(n_out) * 0.05).astype(f32)}

    def bn(n):
        p = {"scale": rng.uniform(0.8, 1.2, n).astype(f32),
             "bias": (rng.standard_normal(n) * 0.1).astype(f32)}
        s = {"mean": (rng.standard_normal(n) * 0.1).astype(f32),
             "var": rng.uniform(0.5, 1.5, n).astype(f32)}
        return p, s

    ss = board_size * board_size
    params: Dict = {"Conv_0": conv(3, 3, num_filters)}
    stats: Dict = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn(num_filters)
    for i in range(num_blocks):
        blk, blk_s = {}, {}
        for j in range(2):
            blk[f"Conv_{j}"] = conv(3, num_filters, num_filters)
            blk[f"BatchNorm_{j}"], blk_s[f"BatchNorm_{j}"] = bn(num_filters)
        params[f"ResBlock_{i}"], stats[f"ResBlock_{i}"] = blk, blk_s
    params["Conv_1"] = conv(1, num_filters, 2)
    params["BatchNorm_1"], stats["BatchNorm_1"] = bn(2)
    params["Dense_0"] = dense(2 * ss, ss + 1)
    params["Conv_2"] = conv(1, num_filters, 1)
    params["BatchNorm_2"], stats["BatchNorm_2"] = bn(1)
    params["Dense_1"] = dense(ss, value_hidden)
    params["Dense_2"] = dense(value_hidden, 1)
    return {"params": params, "batch_stats": stats}
