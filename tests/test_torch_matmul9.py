"""The port's bf16 ``matmul9`` trunk (plain version, as it runs on the CPU)
against the JAX package's Pallas ``_trunk_kernel`` in interpret mode.

Tolerances:
- folded weights: equal; folded biases atol 1e-6 (XLA may rewrite
  x / sqrt(y) as x * rsqrt(y));
- trunk output: PyTorch's bf16 default (rtol 1.6e-2, atol 1e-5); the nine
  products are exact in f32 and only the order of the f32 sums differs;
- ``FusedInference``: probs atol 0.03, value atol 0.05, the JAX package's
  own bar for ``matmul9`` (``tests/test_pallas_resnet.py``), and the same
  top action.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models.pallas_resnet import FusedInference as JaxFused
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import fold_block_params as j_fold
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import fused_trunk
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_matmul9 import (
    conv_matmul9,
    conv_plain,
    trunk_matmul9,
    trunk_matmul9_plain,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet

NUM_BLOCKS, NUM_FILTERS = 2, 32


def port_fused(variables, num_blocks=NUM_BLOCKS, num_filters=NUM_FILTERS):
    m = OthelloResNet(num_blocks, num_filters)
    m.load_state_dict(from_jax_variables(variables))
    return FusedInference(m, variant="matmul9")


def boards(batch, seed):
    return np.random.default_rng(seed).integers(0, 2, (batch, 8, 8, 3)).astype(np.float32)


def test_folded_weights_match_jax():
    v = init_numpy_variables(NUM_BLOCKS, NUM_FILTERS, seed=3)
    fi = port_fused(v)
    w, b = j_fold(v, NUM_BLOCKS)
    assert fi.trunk_w.dtype == torch.bfloat16 and fi.trunk_w.shape == (4, 3, 3, 32, 32)
    np.testing.assert_array_equal(fi.trunk_w.float().numpy(), np.asarray(w.astype(jnp.float32)))
    np.testing.assert_allclose(fi.trunk_bias.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch", [8, 24])
def test_plain_trunk_matches_pallas_interpret(batch):
    v = init_numpy_variables(NUM_BLOCKS, NUM_FILTERS, seed=batch)
    fi = port_fused(v)
    h = fi.stem(torch.from_numpy(boards(batch, seed=batch + 1)))
    w, b = j_fold(v, NUM_BLOCKS)
    ref = fused_trunk(jnp.asarray(h.float().numpy()).astype(jnp.bfloat16), w, b, NUM_BLOCKS,
                      interpret=True)
    out = trunk_matmul9_plain(h, fi.trunk_w, fi.trunk_bias)
    assert out.dtype == torch.bfloat16 and out.shape == h.shape
    torch.testing.assert_close(out.float(), torch.from_numpy(np.asarray(ref.astype(jnp.float32))),
                               rtol=1.6e-2, atol=1e-5)


@pytest.mark.parametrize("batch", [8, 24])
def test_fused_inference_matches_jax(batch):
    v = init_numpy_variables(NUM_BLOCKS, NUM_FILTERS, seed=7)
    x = boards(batch, seed=batch)
    jm = JaxResNet(num_blocks=NUM_BLOCKS, num_filters=NUM_FILTERS)
    lp_j, v_j = JaxFused(jm, interpret=True, variant="matmul9")(v, jnp.asarray(x))
    lp_t, v_t = port_fused(v)(torch.from_numpy(x))
    assert lp_t.shape == (batch, 65) and v_t.shape == (batch, 1)
    probs_t, probs_j = np.exp(lp_t.numpy()), np.exp(np.asarray(lp_j))
    np.testing.assert_allclose(probs_t, probs_j, atol=0.03, rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=0.05, rtol=0)
    np.testing.assert_array_equal(probs_t.argmax(-1), probs_j.argmax(-1))


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    fi = port_fused(init_numpy_variables(NUM_BLOCKS, NUM_FILTERS, seed=2))
    h = fi.stem(torch.from_numpy(boards(4, seed=3)))
    before = trunk_matmul9.launches
    out = trunk_matmul9(h, fi.trunk_w, fi.trunk_bias)
    y = conv_matmul9(h, fi.trunk_w[0], fi.trunk_bias[0])
    z = conv_matmul9(y, fi.trunk_w[1], fi.trunk_bias[1], resid=h)
    assert trunk_matmul9.launches == before
    assert torch.equal(out, trunk_matmul9_plain(h, fi.trunk_w, fi.trunk_bias))
    assert torch.equal(z, conv_plain(y, fi.trunk_w[1], fi.trunk_bias[1], h))
    assert torch.equal(trunk_matmul9_plain(h, fi.trunk_w[:2], fi.trunk_bias[:2]), z)


@pytest.mark.parametrize("bad", ["x_dtype", "x_shape", "w_dtype", "w_odd_layers", "w_shape",
                                 "bias_dtype", "not_contiguous"])
def test_wrapper_rejects_bad_arguments(bad):
    L, C = 2, 32
    x = torch.zeros((2, 8, 8, C), dtype=torch.bfloat16)
    w = torch.zeros((L, 3, 3, C, C), dtype=torch.bfloat16)
    b = torch.zeros((L, C))
    if bad == "x_dtype":
        x = x.float()
    elif bad == "x_shape":
        x = x[:, :, :7]
    elif bad == "w_dtype":
        w = w.float()
    elif bad == "w_odd_layers":
        w, b = w[:1], b[:1]
    elif bad == "w_shape":
        w = w[..., :16]
    elif bad == "bias_dtype":
        b = b.double()
    elif bad == "not_contiguous":
        x = torch.zeros((2, 8, 8, 2 * C), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError):
        trunk_matmul9(x, w, b)


def test_matmul9_and_int8_variants_share_stem_and_heads():
    m = OthelloResNet(1, 128)
    m.load_state_dict(from_jax_variables(init_numpy_variables(1, 128, seed=4)))
    fi, fq = FusedInference(m, variant="matmul9"), FusedInference(m, variant="int8_dx3")
    x = torch.from_numpy(boards(4, seed=5))
    assert torch.equal(fi.stem(x), fq.stem(x))
    h = fi.stem(x)
    lp_a, v_a = fi.heads(h)
    lp_b, v_b = fq.heads(h)
    assert torch.equal(lp_a, lp_b) and torch.equal(v_a, v_b)
