"""Carry flax-layout weights into the port's :class:`OthelloResNet` and back.

The JAX package stores the network as a flax tree ``{"params",
"batch_stats"}``; ``jax.tree.map(np.asarray, variables)`` turns it into
nested dicts of numpy arrays, which is what :func:`from_jax_variables`
takes and :func:`to_jax_variables` returns. No jax is needed here.

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


def _variables_tree(conv, dense, bn, num_blocks: int, num_filters: int,
                    board_size: int, value_hidden: int) -> Dict:
    """The flax ``{params, batch_stats}`` tree of ``OthelloResNet``, its
    leaves drawn by ``conv(kh, cin, cout)``, ``dense(n_in, n_out)`` and
    ``bn(n) -> (params, stats)`` in the module's order."""
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

    return _variables_tree(conv, dense, bn, num_blocks, num_filters, board_size, value_hidden)


def to_jax_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Port state dict -> flax ``{params, batch_stats}`` of float32 numpy
    arrays: the inverse of :func:`from_jax_variables` (``num_batches_tracked``
    has no flax counterpart and is dropped)."""

    def a(key: str) -> np.ndarray:
        return state_dict[key].detach().to("cpu", torch.float32).numpy().copy()

    def conv_k(key: str) -> Dict:
        return {"kernel": np.ascontiguousarray(np.transpose(a(key), (2, 3, 1, 0)))}

    def bn(prefix: str):
        return ({"scale": a(f"{prefix}.weight"), "bias": a(f"{prefix}.bias")},
                {"mean": a(f"{prefix}.running_mean"), "var": a(f"{prefix}.running_var")})

    params: Dict = {"Conv_0": conv_k("conv_block.conv.weight")}
    stats: Dict = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("conv_block.bn")
    num_blocks = len({k.split(".")[1] for k in state_dict if k.startswith("res_blocks.")})
    for i in range(num_blocks):
        p = f"res_blocks.{i}"
        blk, blk_s = {"Conv_0": conv_k(f"{p}.conv1.weight"),
                      "Conv_1": conv_k(f"{p}.conv2.weight")}, {}
        blk["BatchNorm_0"], blk_s["BatchNorm_0"] = bn(f"{p}.bn1")
        blk["BatchNorm_1"], blk_s["BatchNorm_1"] = bn(f"{p}.bn2")
        params[f"ResBlock_{i}"], stats[f"ResBlock_{i}"] = blk, blk_s

    params["Conv_1"] = conv_k("policy_head.conv.weight")
    params["BatchNorm_1"], stats["BatchNorm_1"] = bn("policy_head.bn")
    fc_w = a("policy_head.fc.weight")  # (A, 2*S*S), port (NCHW) column order
    board_size = int(round(np.sqrt(fc_w.shape[1] // 2)))
    kernel = np.empty_like(fc_w.T)
    kernel[policy_fc_perm(board_size)] = fc_w.T
    params["Dense_0"] = {"kernel": kernel, "bias": a("policy_head.fc.bias")}

    params["Conv_2"] = conv_k("value_head.conv.weight")
    params["BatchNorm_2"], stats["BatchNorm_2"] = bn("value_head.bn")
    params["Dense_1"] = {"kernel": np.ascontiguousarray(a("value_head.fc1.weight").T),
                         "bias": a("value_head.fc1.bias")}
    params["Dense_2"] = {"kernel": np.ascontiguousarray(a("value_head.fc2.weight").T),
                         "bias": a("value_head.fc2.bias")}
    return {"params": params, "batch_stats": stats}


def init_train_variables(num_blocks: int, num_filters: int, seed: int,
                         board_size: int = 8, value_hidden: int = 256) -> Dict:
    """A flax-shaped tree drawn as flax initialises ``OthelloResNet``, from a
    numpy seed: conv and dense kernels LeCun-normal (truncated at two
    standard deviations, fan-in scaling), dense biases 0, BatchNorm scale 1,
    shift 0, running mean 0 and variance 1. The trainer starts from it."""
    rng = np.random.default_rng(seed)

    def lecun(shape, fan_in):
        x = rng.standard_normal(shape)
        bad = np.abs(x) > 2
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(x) > 2
        # 0.8796...: the std of a unit normal truncated to [-2, 2]
        return (x * np.sqrt(1.0 / fan_in) / 0.87962566103423978).astype(np.float32)

    def conv(kh, cin, cout):
        return {"kernel": lecun((kh, kh, cin, cout), kh * kh * cin)}

    def dense(n_in, n_out):
        return {"kernel": lecun((n_in, n_out), n_in), "bias": np.zeros(n_out, np.float32)}

    def bn(n):
        return ({"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)},
                {"mean": np.zeros(n, np.float32), "var": np.ones(n, np.float32)})

    return _variables_tree(conv, dense, bn, num_blocks, num_filters, board_size, value_hidden)
