"""The ``int8`` (output-shift) trunk: the plain PyTorch version against the
JAX Pallas kernel ``_trunk_kernel_int8`` in interpret mode, the int32-to-bf16
rounding it stages through, and ``FusedInference`` with the variants
``int8``, ``int8_bf16`` and ``int8_xla`` against the JAX package's.
``tests/test_torch_cuda.py`` holds the kernel against the plain version on a
CUDA card (bit-exact).

Tolerances, each with its reason:
- plain trunk vs ``fused_trunk_int8(kernel="out_shift"/"out_shift_bf16",
  interpret=True)`` at 2 blocks x 32 channels: at most 1 bf16 ulp (int32
  path) or 2 (bf16 path) in under 1e-3 of the outputs. XLA's CPU compiler
  contracts the interpreted kernel's dequantisation ``acc * scale + bias``
  into a fused multiply-add, the port rounds the product and the sum
  separately (as for ``int8_dx3``); an ulp of f32 there can flip one int8
  code of the next layer. ``test_fused_dequant_witness`` shows that this is
  the only difference on the int32 path: with the multiply-add fused the
  plain trunk equals the interpreted kernel bit for bit;
- the int32-to-bf16 conversion: bit-exact to XLA's, which rounds through
  f32 (twice, above 2^24);
- the K-major weights of the int8 conv body, from the tap-major and the dx3
  layouts: equal, per tap and channel, to the JAX package's tap-major
  weights; the conv body's order of the sums (int32 in any tap order; with
  ``stage_bf16`` each tap from zero, rounded, added in f32 in the K-major
  order) equal bit for bit to the plain version;
- ``FusedInference`` vs the JAX ``FusedInference`` of the same variant:
  probabilities atol 0.02 and values atol 0.04, the repo's bar between int8
  trunks (``tests/test_torch_trunk.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from othello_reinforcement_learning_test_tpu.models import quantized as jq
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import (
    FusedInference as JaxFused,
    fused_trunk_int8,
)
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu_torch.kernels import trunk_int8_dx3 as dx3
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8 import (
    kmajor_weights,
    tap_major,
    trunk_int8,
    trunk_int8_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_matmul9 import OFFSETS
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import dx3_weights
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet

NUM_BLOCKS, CHANNELS = 2, 32


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps of two non-negative bf16-valued f32 arrays."""
    return np.abs((a.view(np.int32) >> 16) - (b.view(np.int32) >> 16))


def case(batch, seed=3):
    """(JAX quantized trunk, bf16 post-ReLU input) from numpy seeds."""
    jqt = jq.quantize_trunk(init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=seed), NUM_BLOCKS)
    rng = np.random.default_rng(batch + seed)
    h = np.abs(rng.standard_normal((batch, 8, 8, CHANNELS))) * rng.random((batch, 1, 1, 1)) * 2
    return jqt, jnp.asarray(h, jnp.float32).astype(jnp.bfloat16)


def torch_args(jqt, hb):
    """(x, the kernel's K-major weights, w_scale, bias) from the JAX
    quantized trunk."""
    x = torch.from_numpy(np.array(hb.astype(jnp.float32))).to(torch.bfloat16)
    w = kmajor_weights(torch.from_numpy(np.array(jqt.w_int8)))
    return x, w, *(torch.from_numpy(np.array(a)) for a in (jqt.w_scale, jqt.bias))


def pallas(jqt, hb, stage_bf16):
    out = fused_trunk_int8(hb, jqt.w_int8, jqt.w_scale, jqt.bias, NUM_BLOCKS, block_games=16,
                           interpret=True, kernel="out_shift_bf16" if stage_bf16 else "out_shift")
    return np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("stage_bf16,ulps", [(False, 1), (True, 2)])
@pytest.mark.parametrize("batch", [32, 24])  # bg 16 and bg 8
def test_plain_trunk_matches_pallas_interpret(batch, stage_bf16, ulps):
    jqt, hb = case(batch)
    ref = pallas(jqt, hb, stage_bf16)
    out = trunk_int8_plain(*torch_args(jqt, hb), 16, stage_bf16).float().numpy()
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    assert bf16_ulps(out, ref).max() <= ulps
    assert (out != ref).mean() < 1e-3


def fused_dequant_conv(h, taps, offsets, w_scale, bias, bg):
    """``dx3.int8_conv3x3`` (int32 path) with ``acc * scale + bias`` taken
    as one fused multiply-add, emulated in float64 (the product of an f32
    integer below 2^25 and an f32 scale is exact there)."""
    B, S, _, C = h.shape
    s_act = dx3.div127(h.abs().reshape(B // bg, -1).amax(dim=1).clamp_min(1e-8))
    s_rows = s_act.repeat_interleave(bg)
    q = torch.round(h / s_rows[:, None, None, None]).clamp(-127, 127)
    qp = F.pad(q, (0, 0, 1, 1, 1, 1)).to(torch.float64)
    acc = sum(qp[:, 1 + dy:1 + dy + S, 1 + dx:1 + dx + S, :].reshape(-1, C)
              @ taps[k * C:(k + 1) * C].to(torch.float64) for k, (dy, dx) in enumerate(offsets))
    scale = (s_rows[:, None] * w_scale[None, :]).to(torch.float64)
    acc = acc.to(torch.float32).to(torch.float64).reshape(B, S, S, C)
    return (acc * scale[:, None, None, :] + bias.to(torch.float64)).to(torch.float32)


@pytest.mark.parametrize("batch", [32, 24])
def test_fused_dequant_witness(batch, monkeypatch):
    jqt, hb = case(batch)
    ref = pallas(jqt, hb, stage_bf16=False)
    monkeypatch.setattr(dx3, "int8_conv3x3",
                        lambda h, taps, offsets, s, b, bg, stage_bf16: fused_dequant_conv(
                            h, taps, offsets, s, b, bg))
    out = trunk_int8_plain(*torch_args(jqt, hb), 16).float().numpy()
    np.testing.assert_array_equal(out, ref)


def test_int32_to_bf16_rounds_through_f32():
    """XLA converts int32 to bf16 through f32, which rounds twice above
    2^24; the plain version and the kernel round in the same two steps."""
    v = np.array([2 ** 24 + 65537, -(2 ** 24 + 65537), 2 ** 24 + 3 * 65536 + 1, 19_000_001,
                  2 ** 23 + 32769, 18_580_608, -18_580_608, 5, 0, 2 ** 31 - 1], np.int32)
    xla = np.asarray(jax.jit(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32))(v))
    port = torch.from_numpy(v).to(torch.float64).to(torch.float32).to(torch.bfloat16)
    np.testing.assert_array_equal(port.to(torch.float32).numpy(), xla)
    # 2^24 + 65537 lies nearer 2^24 + 2^17, but f32 rounds it to the bf16
    # midpoint 2^24 + 2^16, and the tie goes to the even 2^24
    assert xla[0] == 2 ** 24


def test_block_scale_is_part_of_the_output():
    """bg 16 halves to 8 at B=24, and each block of 8 games depends only on
    its own games."""
    jqt, hb = case(24)
    x, w, s, b = torch_args(jqt, hb)
    x[:8] *= 4
    per_block = trunk_int8_plain(x, w, s, b, 16)
    assert not torch.equal(per_block, trunk_int8_plain(x, w, s, b, 24))
    alone = trunk_int8_plain(x[8:16].contiguous(), w, s, b, 16)
    assert torch.equal(per_block[8:16], alone)


def test_bf16_staging_changes_the_output():
    jqt, hb = case(32)
    args = torch_args(jqt, hb)
    assert not torch.equal(trunk_int8_plain(*args, 16, False), trunk_int8_plain(*args, 16, True))


def test_wrapper_on_cpu_is_the_plain_version():
    jqt, hb = case(24)
    args = torch_args(jqt, hb)
    before = trunk_int8.launches
    for stage in (False, True):
        assert torch.equal(trunk_int8(*args, 16, stage), trunk_int8_plain(*args, 16, stage))
    assert trunk_int8.launches == before
    x, w, s, b = args
    with pytest.raises(ValueError):
        trunk_int8(x, w.transpose(1, 2).contiguous(), s, b)
    with pytest.raises(ValueError):
        trunk_int8(x.float(), w, s, b)
    with pytest.raises(ValueError):
        trunk_int8(x, w[:1], s[:1], b[:1])


def test_tap_major_layout():
    w = torch.arange(2 * 4 * 36, dtype=torch.int64).reshape(2, 4, 36)
    t = tap_major(w)
    for k in range(9):
        assert torch.equal(t[:, k * 4:(k + 1) * 4, :], w[:, :, k * 4:(k + 1) * 4])
    assert OFFSETS[1] == (-1, 0) and OFFSETS[3] == (0, -1)  # dy-major, as _OFFSETS


@pytest.mark.parametrize("variant", ["int8", "int8_bf16", "int8_xla"])
def test_fused_inference_matches_jax(variant):
    num_blocks, batch = 2, 16
    variables = init_numpy_variables(num_blocks, 128, seed=13)
    jm = JaxResNet(num_blocks=num_blocks, num_filters=128)
    x = np.random.default_rng(batch).integers(0, 2, (batch, 8, 8, 3)).astype(np.float32)
    lp_j, v_j = JaxFused(jm, interpret=True, variant=variant)(variables, jnp.asarray(x))
    m = OthelloResNet(num_blocks, 128)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    fused = FusedInference(m.eval(), variant=variant)
    lp_t, v_t = fused(torch.from_numpy(x))
    assert lp_t.shape == (batch, 65) and v_t.shape == (batch, 1)
    np.testing.assert_allclose(np.exp(lp_t.numpy()), np.exp(np.asarray(lp_j)), atol=0.02, rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=0.04, rtol=0)


def port_model(variables):
    m = OthelloResNet(NUM_BLOCKS, CHANNELS)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m.eval()


def block_size(batch):
    return dx3.block_size(batch, 16)


@pytest.mark.parametrize("layout", ["int8", "int8_dx3"])
def test_kmajor_relayout_matches_jax_tap_major(layout):
    """The int8 conv body's (L, 9, C_out, C_in) weights: tap k's (C_out,
    C_in) matrix is the transpose of columns [k*C, (k+1)*C) of the JAX
    package's (L, C, 9C) weights, for the ``int8`` relayout of
    ``quantize_trunk``'s layout and for the ``int8_dx3`` one of the dx3
    layout (``fused_trunk_int8(kernel="dx3")``'s reshape); taps in
    ``OFFSETS`` order."""
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=7)
    jqt = jq.quantize_trunk(variables, NUM_BLOCKS)
    want = np.array(jqt.w_int8)
    L, C = 2 * NUM_BLOCKS, CHANNELS
    if layout == "int8":
        w = kmajor_weights(torch.from_numpy(want))
    else:
        jdx3 = jqt.w_int8.reshape(L, C, 3, 3, C).transpose(0, 3, 1, 2, 4).reshape(L, 3, C, 3 * C)
        assert torch.equal(dx3_weights(torch.from_numpy(want)), torch.from_numpy(np.array(jdx3)))
        w = dx3.dx3_kmajor(torch.from_numpy(np.array(jdx3)))
    fused = FusedInference(port_model(variables), variant=layout)
    assert torch.equal(fused.trunk_w, w) and w.is_contiguous()
    assert w.dtype == torch.int8 and w.shape == (L, 9, C, C)
    for k in range(9):
        np.testing.assert_array_equal(w[:, k].numpy(), want[:, :, k * C:(k + 1) * C]
                                      .transpose(0, 2, 1))
    assert OFFSETS[0] == (-1, -1) and OFFSETS[1] == (-1, 0)  # dy-major, as _OFFSETS


def kernel_order_trunk(x, w, w_scale, bias, bg, stage_bf16, taps=range(9)):
    """The trunk as the int8 conv body sums it: each tap's product of the
    shifted int8 codes with the K-major matrix ``w[layer, k]`` in int64,
    over ``taps``; int32 mode sums them exactly, ``stage_bf16`` takes each
    from zero, rounds it through f32 to bf16 and adds it in f32; then
    ``s_act * w_scale`` first, the product and the bias rounded apart, the
    residual and ReLU in f32."""
    h = x.to(torch.float32)
    B, S, _, C = h.shape
    for layer in range(w.shape[0]):
        s_act = dx3.div127(h.abs().reshape(B // bg, -1).amax(dim=1).clamp_min(1e-8))
        s_rows = s_act.repeat_interleave(bg)
        q = torch.round(h / s_rows[:, None, None, None]).clamp(-127, 127).to(torch.int64)
        qp = F.pad(q, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros((B * S * S, C), dtype=torch.float32 if stage_bf16 else torch.int64)
        for k in taps:
            dy, dx = OFFSETS[k]
            part = qp[:, 1 + dy:1 + dy + S, 1 + dx:1 + dx + S, :].reshape(-1, C) \
                @ w[layer, k].to(torch.int64).T
            if stage_bf16:
                part = part.to(torch.float32).to(torch.bfloat16).to(torch.float32)
            acc = acc + part
        scale = s_rows[:, None] * w_scale[layer][None, :]
        z = acc.to(torch.float32).reshape(B, S, S, C) * scale[:, None, None, :] + bias[layer]
        if layer % 2 == 0:
            block_in, h = h, torch.relu(z)
        else:
            h = torch.relu(block_in + z)
    return h.to(torch.bfloat16)


@pytest.mark.parametrize("batch", [32, 24])
def test_bf16_staging_in_kmajor_tap_order_is_the_plain_version(batch):
    """``int8_bf16``: each tap's product taken from zero, rounded through f32
    to bf16 and added in f32 in the K-major layout's tap order, as the conv
    body sums it, is the plain version bit for bit."""
    jqt, hb = case(batch)
    x, w, s, b = torch_args(jqt, hb)
    plain = trunk_int8_plain(x, w, s, b, 16, stage_bf16=True)
    assert torch.equal(kernel_order_trunk(x, w, s, b, block_size(batch), True), plain)
    assert torch.equal(trunk_int8(x, w, s, b, 16, stage_bf16=True), plain)


@pytest.mark.parametrize("order", ["reversed", "dx_major", "shuffled"])
def test_int32_sum_is_the_same_in_any_tap_order(order):
    """The int32 mode (``int8``, ``int8_dx3``) sums exact integers: any order
    of the nine taps gives the plain version bit for bit."""
    jqt, hb = case(32)
    x, w, s, b = torch_args(jqt, hb)
    taps = {"reversed": range(8, -1, -1),
            "dx_major": [3 * (dy + 1) + dx + 1 for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
            "shuffled": np.random.default_rng(0).permutation(9).tolist()}[order]
    got = kernel_order_trunk(x, w, s, b, 16, False, taps)
    assert torch.equal(got, trunk_int8_plain(x, w, s, b, 16))
    assert torch.equal(got, dx3.trunk_int8_dx3_plain(x, w, s, b, 16))



def test_reciprocal_quantisation_rounds_as_the_division():
    """The int8 conv body quantizes with the block's reciprocal
    (``csrc/int8_conv_sm90.cuh::quantize_into``): clip(h * (1 / s)),
    rounded by adding 1.5 * 2^23, and divided exactly where a value lies
    within 2^-14 of a half-integer (the kernel then divides all of that
    thread's values). Emulated here step for step in float32, it gives the
    plain version's ``round(h / s).clamp(-127, 127)`` on random values,
    zeros and quotients one ulp from a half-integer, at scales from 1e-8 to
    1e4."""
    f32 = np.float32
    magic, near_half = f32(12582912.0), f32(0.5) - f32(1.0 / 16384)
    rng = np.random.default_rng(0)
    for amax in (1e-8, 3e-6, 0.37, 1.0, 2.5, 77.0, 1e4):
        s = (torch.tensor([max(amax, 1e-8)], dtype=torch.float32) / 127).numpy()[0]
        y = f32(1) / s
        h = rng.random(200_000, dtype=np.float32) * f32(amax)
        h[::5] = 0
        halves = (rng.integers(-127, 127, 20_000).astype(f32) + f32(0.5)) * s
        up = rng.random(halves.size) < 0.5
        halves = np.nextafter(halves.astype(f32), np.where(up, np.inf, -np.inf).astype(f32))
        h = np.concatenate([h, halves.astype(f32), -h[:1000]])
        want = torch.round(torch.from_numpy(h) / torch.tensor(s)).clamp(-127, 127).numpy()
        q = np.clip((h * y).astype(f32), -127, 127).astype(f32)
        r = (q + magic).astype(f32)
        near = np.abs((q - (r - magic).astype(f32)).astype(f32)) > near_half
        exact = np.clip((h / s).astype(f32), -127, 127).astype(f32)
        r = np.where(near, (exact + magic).astype(f32), r)
        got = (r.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8).astype(f32)
        np.testing.assert_array_equal(got, want)
        assert near.mean() < 0.2  # the exact division stays the exception
