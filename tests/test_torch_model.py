"""PyTorch port of the network, weight conversion and int8 quantization
against the JAX package.

Tolerances, each with its reason:
- f32 network vs flax ``model.apply(dtype=float32)``: atol 1e-5, the bar of
  ``tests/test_torch_bridge.py`` (the two sum convolutions in other orders);
- folded weights: equal after the bf16 rounding; folded biases atol 1e-6
  (XLA may rewrite x / sqrt(y) as x * rsqrt(y), a few f32 ulps);
- int8 weight codes and scales, and the whole-batch int8 trunk: exact (the
  same IEEE operations on the same inputs; integer sums are exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models import quantized as jq
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import fold_block_params as j_fold
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import block_size
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
    policy_fc_perm,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import (
    FusedInference,
    dx3_weights,
    fold_block_params,
)
from othello_reinforcement_learning_test_tpu_torch.models.quantized import (
    QuantizedTrunk,
    plain_int8_trunk,
    quantize_activations,
    quantize_trunk,
)
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet


def port_model(variables, num_blocks, num_filters, board_size=8):
    m = OthelloResNet(num_blocks, num_filters, board_size)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m.eval()


def board_inputs(batch, size, seed):
    """0/1 planes like the engine's features."""
    return np.random.default_rng(seed).integers(0, 2, (batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("num_blocks,num_filters,size", [(2, 32, 8), (1, 16, 6), (3, 64, 8), (2, 16, 4)])
def test_f32_network_matches_flax(num_blocks, num_filters, size):
    variables = init_numpy_variables(num_blocks, num_filters, seed=num_blocks, board_size=size)
    jm = JaxResNet(num_blocks=num_blocks, num_filters=num_filters, board_size=size,
                   dtype=jnp.float32)
    x = board_inputs(8, size, seed=size)
    lp_j, v_j = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        lp_t, v_t = port_model(variables, num_blocks, num_filters, size)(torch.from_numpy(x))
    assert lp_t.shape == (8, size * size + 1) and v_t.shape == (8, 1)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5, rtol=0)


def test_init_numpy_variables_is_flax_shaped_and_seeded():
    v = init_numpy_variables(2, 16, seed=7)
    jm = JaxResNet(num_blocks=2, num_filters=16)
    ref = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), train=False)

    def shapes(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(k): np.shape(a) for k, a in flat}

    assert shapes(v) == shapes(ref)
    again = init_numpy_variables(2, 16, seed=7)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(again)))
    # non-trivial running statistics, so BN folding is exercised
    st = v["batch_stats"]["ResBlock_0"]["BatchNorm_0"]
    assert np.abs(st["mean"]).max() > 0 and np.abs(st["var"] - 1).max() > 0.1


def test_policy_fc_perm_is_a_permutation():
    for s in (4, 6, 8):
        perm = policy_fc_perm(s)
        assert sorted(perm.tolist()) == list(range(2 * s * s))


def test_fold_block_params_matches_jax():
    variables = init_numpy_variables(2, 128, seed=0)
    m = port_model(variables, 2, 128)
    jw, jb = j_fold(variables, 2)
    tw, tb = fold_block_params(m)
    assert tw.shape == (4, 3, 3, 128, 128) and tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.float().numpy(), np.asarray(jw.astype(jnp.float32)))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6, rtol=0)


def test_quantize_trunk_matches_jax():
    variables = init_numpy_variables(2, 128, seed=1)
    jqt = jq.quantize_trunk(variables, 2)
    tqt = quantize_trunk(port_model(variables, 2, 128))
    assert tqt.w_int8.dtype == torch.int8 and tqt.w_int8.shape == (4, 128, 9 * 128)
    np.testing.assert_array_equal(tqt.w_int8.numpy(), np.asarray(jqt.w_int8))
    np.testing.assert_array_equal(tqt.w_scale.numpy(), np.asarray(jqt.w_scale))


def test_dx3_weights_layout():
    """w_dx3[l, dx+1, cin, (dy+1)*C + cout] == tap (dy, dx) of the HWIO
    kernel, as the JAX package's dx3 relayout lays it out."""
    L, C = 2, 8
    q = torch.randint(-127, 128, (L, 3, 3, C, C), generator=torch.Generator().manual_seed(0))
    w9 = q.reshape(L, 9, C, C).permute(0, 2, 1, 3).reshape(L, C, 9 * C).to(torch.int8)
    wd = dx3_weights(w9)
    assert wd.shape == (L, 3, C, 3 * C)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            got = wd[:, dx + 1, :, (dy + 1) * C:(dy + 2) * C]
            assert torch.equal(got, q[:, dy + 1, dx + 1].to(torch.int8))


def test_quantize_activations_matches_jax():
    h = np.random.default_rng(2).standard_normal((4, 8, 8, 16)).astype(np.float32)
    qj, sj = jq.quantize_activations(jnp.asarray(h))
    qt, st = quantize_activations(torch.from_numpy(h))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)


@pytest.mark.parametrize("batch", [8, 24])
def test_plain_int8_trunk_matches_xla_int8_trunk(batch):
    """Whole-batch activation scale: bit-exact against the JAX lax trunk."""
    variables = init_numpy_variables(2, 128, seed=3)
    jqt = jq.quantize_trunk(variables, 2)
    h = np.abs(np.random.default_rng(batch).standard_normal((batch, 8, 8, 128))).astype(np.float32)
    ref = np.asarray(jq.xla_int8_trunk(jnp.asarray(h), jqt, 2))
    qt = QuantizedTrunk(*(torch.from_numpy(np.array(a)) for a in jqt))
    out = plain_int8_trunk(torch.from_numpy(h), qt).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("batch,block_games,expected", [
    (1024, 64, 64), (24, 64, 8), (96, 64, 32), (3, 64, 1), (8, 64, 8), (48, 16, 16)])
def test_block_size_rule(batch, block_games, expected):
    assert block_size(batch, block_games) == expected


@pytest.mark.parametrize("variant", ["int8_dx4", "xla", "INT8"])
def test_unported_variants_raise(variant):
    """Every variant of the JAX package is ported, so what is left to refuse
    is a name the JAX ``FusedInference`` refuses too: a ValueError."""
    from othello_reinforcement_learning_test_tpu.models.pallas_resnet import (
        FusedInference as JaxFused,
    )

    with pytest.raises(ValueError):
        JaxFused(JaxResNet(num_blocks=1, num_filters=16), variant=variant)
    m = port_model(init_numpy_variables(1, 16, seed=0), 1, 16)
    with pytest.raises(ValueError, match="variant must be one of"):
        FusedInference(m, variant=variant)
