"""The ``int8_dx3`` trunk: the plain PyTorch version against the JAX Pallas
kernel in interpret mode, and the wrapper's CPU and argument behaviour.
``tests/test_torch_cuda.py`` holds the kernel against the plain version on
a CUDA card.

Tolerances, each with its reason:
- plain trunk vs ``fused_trunk_int8(kernel="dx3", interpret=True)`` with the
  same bf16 input and the same int8 weights: every output within 1 bf16 ulp.
  XLA compiles the interpreted kernel body with its own fusions, so a few
  f32 activations differ by an ulp, which can flip a bf16 rounding or one
  int8 code in the next layer;
- ``FusedInference`` vs the JAX ``FusedInference(variant="int8_dx3")``:
  probabilities atol 0.02 and values atol 0.04, the repo's own bar between
  int8 trunks (``tests/test_pallas_resnet.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models import quantized as jq
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import (
    FusedInference as JaxFused,
    fused_trunk_int8,
)
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu_torch.kernels import build
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import (
    dx3_kmajor,
    trunk_int8_dx3,
    trunk_int8_dx3_plain,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference, dx3_weights
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet


def port_model(variables, num_blocks):
    m = OthelloResNet(num_blocks, 128)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m.eval()


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps of two non-negative bf16-valued f32 arrays."""
    ia = a.astype(np.float32).view(np.int32) >> 16
    ib = b.astype(np.float32).view(np.int32) >> 16
    return np.abs(ia - ib)


def trunk_inputs(batch, seed):
    """bf16 post-ReLU activations shaped like the stem's output."""
    h = np.abs(np.random.default_rng(seed).standard_normal((batch, 8, 8, 128)))
    h *= np.random.default_rng(seed + 1).random((batch, 1, 1, 1)) * 2  # per-game ranges
    return jnp.asarray(h, jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("num_blocks,batch", [(2, 8), (2, 24), (3, 8), (3, 24)])
def test_plain_trunk_matches_pallas_interpret(num_blocks, batch):
    variables = init_numpy_variables(num_blocks, 128, seed=num_blocks)
    jqt = jq.quantize_trunk(variables, num_blocks)
    hb = trunk_inputs(batch, seed=batch + num_blocks)
    ref = fused_trunk_int8(hb, jqt.w_int8, jqt.w_scale, jqt.bias, num_blocks,
                           block_games=64, interpret=True, kernel="dx3")
    ref = np.asarray(ref.astype(jnp.float32))
    x = torch.from_numpy(np.array(hb.astype(jnp.float32))).to(torch.bfloat16)
    w = dx3_kmajor(dx3_weights(torch.from_numpy(np.array(jqt.w_int8))))
    out = trunk_int8_dx3_plain(x, w, torch.from_numpy(np.array(jqt.w_scale)),
                               torch.from_numpy(np.array(jqt.bias)), 64)
    out = out.float().numpy()
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    assert bf16_ulps(out, ref).max() <= 1
    assert (out != ref).mean() < 1e-3


def test_block_scale_is_part_of_the_output():
    """With games of very different ranges, bg 8 (B=24) and one block for
    the whole batch give different outputs: the per-block activation scale
    is part of the function."""
    variables = init_numpy_variables(2, 128, seed=5)
    m = port_model(variables, 2)
    fi = FusedInference(m)
    x = torch.from_numpy(np.array(trunk_inputs(24, seed=9).astype(jnp.float32)))
    x = x.to(torch.bfloat16)
    x[:8] *= 4
    per_block = trunk_int8_dx3_plain(x, fi.trunk_w, fi.trunk_scale, fi.trunk_bias, 64)
    whole = trunk_int8_dx3_plain(x, fi.trunk_w, fi.trunk_scale, fi.trunk_bias, 24)
    assert not torch.equal(per_block, whole)
    # each block of 8 games only depends on its own games
    alone = trunk_int8_dx3_plain(x[8:16].contiguous(), fi.trunk_w, fi.trunk_scale,
                                 fi.trunk_bias, 64)
    assert torch.equal(per_block[8:16], alone)


@pytest.mark.parametrize("batch", [8, 24])
def test_fused_inference_matches_jax(batch):
    num_blocks = 2
    variables = init_numpy_variables(num_blocks, 128, seed=11)
    jm = JaxResNet(num_blocks=num_blocks, num_filters=128)
    x = np.random.default_rng(batch).integers(0, 2, (batch, 8, 8, 3)).astype(np.float32)
    lp_j, v_j = JaxFused(jm, interpret=True, variant="int8_dx3")(variables, jnp.asarray(x))
    lp_t, v_t = FusedInference(port_model(variables, num_blocks))(torch.from_numpy(x))
    assert lp_t.shape == (batch, 65) and v_t.shape == (batch, 1)
    np.testing.assert_allclose(np.exp(lp_t.numpy()), np.exp(np.asarray(lp_j)), atol=0.02, rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=0.04, rtol=0)


def test_fused_inference_close_to_flax_bf16():
    """int8 vs the bf16 flax model at the repo's int8 bar (0.08 / 0.15)."""
    variables = init_numpy_variables(2, 128, seed=12)
    jm = JaxResNet(num_blocks=2, num_filters=128)
    x = np.random.default_rng(0).integers(0, 2, (8, 8, 8, 3)).astype(np.float32)
    lp_j, v_j = jm.apply(variables, jnp.asarray(x), train=False)
    lp_t, v_t = FusedInference(port_model(variables, 2))(torch.from_numpy(x))
    np.testing.assert_allclose(np.exp(lp_t.numpy()), np.exp(np.asarray(lp_j)), atol=0.08, rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=0.15, rtol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    fi = FusedInference(port_model(init_numpy_variables(1, 128, seed=2), 1))
    x = torch.from_numpy(np.array(trunk_inputs(4, seed=3).astype(jnp.float32))).to(torch.bfloat16)
    before = trunk_int8_dx3.launches
    out = trunk_int8_dx3(x, fi.trunk_w, fi.trunk_scale, fi.trunk_bias)
    assert trunk_int8_dx3.launches == before
    assert torch.equal(out, trunk_int8_dx3_plain(x, fi.trunk_w, fi.trunk_scale, fi.trunk_bias))


@pytest.mark.parametrize("bad", ["x_dtype", "x_shape", "w_dtype", "w_odd_layers", "scale_shape",
                                 "bias_dtype", "not_contiguous"])
def test_wrapper_rejects_bad_arguments(bad):
    L, C = 2, 128
    x = torch.zeros((2, 8, 8, C), dtype=torch.bfloat16)
    w = torch.zeros((L, 9, C, C), dtype=torch.int8)
    s = torch.ones((L, C))
    b = torch.zeros((L, C))
    if bad == "x_dtype":
        x = x.float()
    elif bad == "x_shape":
        x = x[:, :, :7]
    elif bad == "w_dtype":
        w = w.float()
    elif bad == "w_odd_layers":
        w, s, b = w[:1], s[:1], b[:1]
    elif bad == "scale_shape":
        s = s[:, :64]
    elif bad == "bias_dtype":
        b = b.double()
    elif bad == "not_contiguous":
        x = torch.zeros((2, 8, 8, 2 * C), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError):
        trunk_int8_dx3(x, w, s, b)


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
