"""The port's trunks past 128 channels and at widths that are no multiple of
16, on the CPU, where the wrappers run their plain versions:

- zero channels: each of the nine plain trunks (``matmul9``, ``wide``,
  ``int8``, ``int8_bf16``, ``int8_m9``, ``int8_patch``, ``int8_flat``,
  ``int8_dx3``, ``int8_dxcat``) at a raw width (8, 40, 200 channels) equals
  the same trunk on activations and weights padded with zero channels to
  the kernels' width (``kernels/build.py::padded_channels``), the output cut
  back: the int8 ones bit for bit, the bf16 ones in value. Zero channels do
  not raise a per-block amax and quantize to 0, zero weights add exact
  zeros to the int32 and f32 sums, a zero bias keeps the pad at 0 through
  ReLU. (The bf16 plain versions sum each product's f32 terms in the CPU
  GEMM's own blocking, which can change with K: at 100 channels on 8x8 the
  ``wide`` trunk's padded run differs by a bf16 ulp in 2e-4 of its values,
  which is the GEMM's order, not the padding; the card's kernels take the
  padded width in any case.)
- an independent numpy reference of the int8 trunk function (exact integer sums in float64,
  every f32 operation rounded on its own, the activation scale a true
  division by 127): the port's plain int8 variants, through
  ``FusedInference``, equal it value for value at 8x8 x 256, at 6x6 x 40
  (weights of ``init_numpy_variables(1, 40, seed=0)``, the input of
  ``test_torch_shapes.py``'s formula from ``default_rng(1)``, B = 8) and at
  4x4 x 24 (a padded width);
- the stated JAX-on-CPU difference at that 6x6 x 40 input: the interpreted
  Pallas ``int8_dx3`` kernel departs from the port in 27% of its values,
  and equals the numpy reference with the one change that XLA's CPU
  compiler makes: ``max(amax, 1e-8) / 127`` taken as a multiplication by
  the f32 reciprocal of 127 (the jitted kernel body's HLO holds
  ``multiply(max, 0.00787401572)``), which moves the scale by an ulp, flips
  a few int8 codes, and the sums carry them on.

The plain trunks at 8x8 x 256 against the interpreted Pallas kernels are
``test_torch_shapes.py``'s; the CUDA kernels at these shapes are held to
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase ``shapes``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models import quantized as jq
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import (
    fold_block_params as j_fold,
    fold_block_params_wide as j_fold_wide,
    fused_trunk,
    fused_trunk_int8,
    fused_trunk_wide,
)
from othello_reinforcement_learning_test_tpu_torch.kernels import build
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8 import trunk_int8
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import (
    int8_at_width,
    trunk_int8_dx3,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dxcat import trunk_int8_dxcat
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_flat import trunk_int8_flat
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_m9 import trunk_int8_m9
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_patch import trunk_int8_patch
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_matmul9 import (
    OFFSETS,
    at_width,
    hwio_at_width,
    trunk_matmul9,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_wide import (
    trunk_wide,
    wide_at_width,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import (
    DEFAULT_BLOCK_GAMES,
    FusedInference,
)
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet

INT8_WRAPPERS = {"int8": trunk_int8, "int8_bf16": functools.partial(trunk_int8, stage_bf16=True),
                 "int8_m9": trunk_int8_m9, "int8_patch": trunk_int8_patch,
                 "int8_flat": trunk_int8_flat, "int8_dx3": trunk_int8_dx3,
                 "int8_dxcat": trunk_int8_dxcat}
VARIANTS = ("matmul9", "wide", *INT8_WRAPPERS)
# (board side, raw width): every board side, a width below 16, one between
# and one past 128
PAD_CASES = [(8, 8), (6, 40), (4, 200)]
BATCH = 8
# name -> (board side, channels, weight seed, input seed); "6x6x40" is the
# input at which the interpreted Pallas kernel departs (see the docstring)
REF_CASES = {"8x8x256": (8, 256, 5, 16), "6x6x40": (6, 40, 0, 1), "4x4x24": (4, 24, 4, 5)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op pool at one thread, as in ``test_torch_shapes.py``:
    the test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def raw_args(variant, S, C, seed=0):
    """(x, weights..., ) of ``variant``'s wrapper at width C: 1 block, from
    a numpy seed; the int8 weights in the K-major (L, 9, C_out, C_in) layout."""
    rng = np.random.default_rng(seed + C)
    x = torch.from_numpy(np.abs(rng.standard_normal((BATCH, S, S, C))).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal((2, C)) * 0.1).astype(np.float32))
    if variant in ("matmul9", "wide"):
        tail = (3, 3, C, C) if variant == "matmul9" else (C, 9 * C)
        w = torch.from_numpy((rng.standard_normal((2, *tail)) * 0.1).astype(np.float32))
        return x.to(torch.bfloat16), w.to(torch.bfloat16), bias
    w = torch.from_numpy(rng.integers(-127, 128, (2, 9, C, C)).astype(np.int8))
    scale = torch.from_numpy((rng.random((2, C)) * 0.01 + 1e-3).astype(np.float32))
    return x.to(torch.bfloat16), w, scale, bias


def padded(variant, args, width):
    """The weights of ``args`` with zero channels up to ``width``, as
    ``FusedInference`` pads them once."""
    if variant in ("matmul9", "wide"):
        _, w, bias = args
        return ((wide_at_width if variant == "wide" else hwio_at_width)(w, width),
                at_width(bias, (1,), width))
    return int8_at_width(*args[1:], width)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


@pytest.mark.parametrize("size,channels", PAD_CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_trunk_is_exact_under_zero_channels(variant, size, channels):
    """The trunk at C channels equals the trunk at the kernels' width on
    zero-padded activations and weights, cut back: the wrapper's own
    padding (raw x, padded weights) and an explicit run at the padded width,
    whose pad channels stay 0."""
    kernel = INT8_WRAPPERS.get(variant, trunk_matmul9 if variant == "matmul9" else trunk_wide)
    args = raw_args(variant, size, channels)
    width = build.padded_channels(channels)
    assert width % 16 == 0 and width - channels < 16 and width != channels
    wp = padded(variant, args, width)
    out = kernel(*args)
    through_wrapper = kernel(args[0], *wp)
    full = kernel(at_width(args[0], (3,), width), *wp)
    assert out.shape == through_wrapper.shape == args[0].shape
    assert full.shape == (BATCH, size, size, width) and not full[..., channels:].any()
    if variant in ("matmul9", "wide"):
        assert torch.equal(out, through_wrapper) and torch.equal(out, full[..., :channels])
    else:
        assert torch.equal(bits(out), bits(through_wrapper))
        assert torch.equal(bits(out), bits(full[..., :channels].contiguous()))


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps of two non-negative bf16-valued f32 arrays."""
    return np.abs((a.view(np.int32) >> 16) - (b.view(np.int32) >> 16))


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) -> f32, on the bits."""
    u = a.astype(np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def numpy_int8_trunk(x, w_int8, w_scale, bias, bg, stage_bf16=False, reciprocal=False,
                     fused_dequant=False):
    """The int8 trunk function in numpy, independent of the port's code:
    x (B, S, S, C) f32 (bf16 values); w_int8 (L, C_in, 9 C_out) tap-major
    as ``quantize_trunk`` makes it; one activation scale per block of bg
    games, ``max(amax, 1e-8) / 127`` (``reciprocal``: times the f32
    reciprocal of 127), codes ``clip(rint(h / s), -127, 127)``, the nine
    shifted products summed exactly (``stage_bf16``: each tap's sum rounded
    to bf16 through f32 and the taps summed in f32 in OFFSETS order), then
    ``f32(acc) * (s * w_scale) + bias`` with every f32 operation rounded on
    its own; ReLU, the residual add, bf16 out."""
    B, S, _, C = x.shape
    L = w_int8.shape[0]
    # integer products summed in float64: every partial sum of 9C products
    # of two int8 codes is an integer below 2^53, so exact (as int64 is,
    # and BLAS-fast)
    taps = w_int8.reshape(L, C, 9, C).transpose(0, 2, 1, 3).astype(np.float64)
    f32 = np.float32

    def conv(h, layer):
        amax = np.abs(h).reshape(B // bg, -1).max(axis=1)
        m = np.maximum(amax, f32(1e-8))
        s = m * f32(1 / 127) if reciprocal else m / f32(127)
        s = np.repeat(s, bg)[:, None, None, None]
        q = np.clip(np.rint(h / s), -127, 127).astype(np.float64)
        qp = np.pad(q, ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = None
        for k, (dy, dx) in enumerate(OFFSETS):
            part = qp[:, 1 + dy:1 + dy + S, 1 + dx:1 + dx + S, :].reshape(-1, C) @ taps[layer, k]
            if stage_bf16:
                part = bf16_round(part.astype(f32))
            acc = part if acc is None else acc + part
        scale = (s.reshape(B, 1) * w_scale[layer][None, :])[:, None, None, :]
        accf = acc.astype(f32).reshape(B, S, S, C)
        if fused_dequant:  # one rounding: the f32 product of an integer below 2^25 is exact in f64
            return (accf.astype(np.float64) * scale + bias[layer]).astype(f32)
        return accf * scale + bias[layer]

    h = x
    for i in range(L // 2):
        y = np.maximum(conv(h, 2 * i), f32(0))
        h = np.maximum(h + conv(y, 2 * i + 1), f32(0))
    return bf16_round(h)


@functools.cache
def ref_case(name):
    """(network variables, JAX quantized trunk, bf16 input as f32) of a
    REF_CASES entry; the input by test_torch_shapes.py's formula."""
    S, C, seed, input_seed = REF_CASES[name]
    variables = init_numpy_variables(1, C, seed=seed, board_size=S)
    rng = np.random.default_rng(input_seed)
    h = np.abs(rng.standard_normal((BATCH, S, S, C))) * rng.random((BATCH, 1, 1, 1)) * 2
    x = np.array(jnp.asarray(h, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
    return variables, jq.quantize_trunk(variables, 1), x


@functools.cache
def reference(name, bg, stage_bf16=False, reciprocal=False, fused_dequant=False):
    _, qt, x = ref_case(name)
    return numpy_int8_trunk(x, *(np.array(a) for a in qt), bg, stage_bf16, reciprocal,
                            fused_dequant)


def port_trunk(name, variant):
    """The port's plain trunk of ``variant`` through ``FusedInference`` on
    the CPU (weights padded there where C is no multiple of 16)."""
    variables, _, x = ref_case(name)
    S, C = REF_CASES[name][:2]
    m = OthelloResNet(1, C, S)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    fused = FusedInference(m.eval(), variant=variant)
    return fused.trunk(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()


def block_games(variant):
    bg = DEFAULT_BLOCK_GAMES[variant]
    while BATCH % bg:
        bg //= 2
    return bg


@pytest.mark.parametrize("name", list(REF_CASES))
@pytest.mark.parametrize("variant", list(INT8_WRAPPERS))
def test_plain_int8_trunk_equals_numpy_reference(variant, name):
    out = port_trunk(name, variant)
    want = reference(name, block_games(variant), variant == "int8_bf16")
    assert out.shape == want.shape and np.all(np.isfinite(out))
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))


JAX_INT8_KERNEL = {"int8": "out_shift", "int8_bf16": "out_shift_bf16", "int8_m9": "m9",
                   "int8_patch": "patch", "int8_flat": "flat", "int8_dx3": "dx3",
                   "int8_dxcat": "dxcat"}


def interpreted(name, variant):
    """The JAX package's Pallas kernel of ``variant`` in interpret mode on
    a REF_CASES entry, at the port's block size for it."""
    variables, qt, x = ref_case(name)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if variant in ("matmul9", "wide"):
        fold = j_fold if variant == "matmul9" else j_fold_wide
        w, b = fold(variables, 1)
        fn = fused_trunk if variant == "matmul9" else fused_trunk_wide
        out = fn(xb, w, b, 1, block_games=DEFAULT_BLOCK_GAMES[variant], interpret=True)
    else:
        out = fused_trunk_int8(xb, qt.w_int8, qt.w_scale, qt.bias, 1,
                               block_games=DEFAULT_BLOCK_GAMES[variant], interpret=True,
                               kernel=JAX_INT8_KERNEL[variant])
    return np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_trunk_matches_pallas_interpret_at_256(variant):
    """The nine plain trunks at 8x8 x 256 (1 block, B = 8, the input of
    ``test_torch_shapes.py``'s formula) against the interpreted Pallas
    kernels. bf16: at most one bf16 ulp in under 1e-3 of the values, the
    bar of the other shapes. int8: exact on both sides instead, since the
    one-ulp bar fails there (``int8_bf16``: 18 ulps at one value) through
    the JAX side: the interpreted kernel equals, bit for bit, the numpy
    reference taken with XLA's two CPU rewrites (the scale's division by
    127 as a multiplication by its reciprocal, and ``acc * scale + bias``
    as one fused multiply-add), and the port equals the reference without
    them (``test_plain_int8_trunk_equals_numpy_reference``)."""
    ref = interpreted("8x8x256", variant)
    out = port_trunk("8x8x256", variant)
    assert out.shape == ref.shape == (BATCH, 8, 8, 256) and np.all(np.isfinite(out))
    if variant in ("matmul9", "wide"):
        assert bf16_ulps(out, ref).max() <= 1
        assert (out != ref).mean() < 1e-3
    else:
        xla = reference("8x8x256", block_games(variant), variant == "int8_bf16", True, True)
        np.testing.assert_array_equal(ref.view(np.uint32), xla.view(np.uint32))


def test_interpreted_pallas_departs_at_6x6x40():
    """The stated JAX-on-CPU difference (see the docstring), not reseeded
    around: at 6x6 x 40 the port equals the numpy reference, the
    interpreted Pallas ``int8_dx3`` kernel differs from both in over a fifth
    of its values, and equals the reference whose activation scale is
    multiplied by the f32 reciprocal of 127: the first operation where the
    two part is ``max(amax, 1e-8) / 127``, one ulp apart at the first
    layer's amax."""
    _, _, x = ref_case("6x6x40")
    pallas = interpreted("6x6x40", "int8_dx3")
    port = port_trunk("6x6x40", "int8_dx3")
    bg = block_games("int8_dx3")
    np.testing.assert_array_equal(port, reference("6x6x40", bg))
    assert (pallas != port).mean() > 0.2
    np.testing.assert_array_equal(pallas, reference("6x6x40", bg, reciprocal=True))
    amax = np.float32(np.abs(x).max())
    assert amax / np.float32(127) != amax * np.float32(1 / 127)
