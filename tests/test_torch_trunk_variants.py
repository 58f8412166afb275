"""The ``wide``, ``int8_m9``, ``int8_patch``, ``int8_flat`` and ``int8_dxcat`` trunks: the
plain PyTorch versions (as the wrappers run them on the CPU) against the JAX
package's Pallas kernels in interpret mode, the weight layouts, the block
sizes and ``FusedInference``. ``tests/test_torch_cuda.py`` holds the CUDA
kernels against the plain versions on a card.

Tolerances, each with its reason:
- plain trunk vs ``fused_trunk_wide`` / ``fused_trunk_int8(kernel="m9" /
  "patch" / "flat" / "dxcat")`` in interpret mode at the variant's default
  block size (32; ``dxcat`` 64), 2 blocks x 32 channels: at most 1 bf16 ulp in under 1e-3 of the outputs, the bar of
  ``tests/test_torch_trunk_int8.py``. On the int8 path XLA's CPU compiler
  fuses the interpreted kernel's dequantisation ``acc * scale + bias`` into
  one multiply-add where the port rounds product and sum, and an ulp of f32
  there can flip an int8 code of the next layer
  (``test_fused_dequant_witness`` there); on the ``wide`` path both sum the
  same bf16 products in the same f32 order. ``int8_dxcat`` at the gate
  match's 40 games: the same bar with that multiply-add emulated in the plain
  version, since on this input it flips one code;
- weight layouts: equal (``int8_m9``, ``int8_patch``, ``int8_flat`` and
  ``int8_dxcat`` take the K-major (L, 9, C_out, C_in) relayout of the JAX
  package's m9, patch (= flat) and dxcat layouts: tap k's (C_out, C_in)
  matrix is the transpose of that layout's tap-k block);
- the five variants of the int8 conv body (``int8_dx3``, ``int8``,
  ``int8_patch``, ``int8_m9``, ``int8_flat``), plain versions on the same
  quantized weights through each one's own relayout: equal;
- the stage edits of ``kernels/conv_stages.py``: each applies exactly once
  to its header;
- ``FusedInference`` vs the JAX ``FusedInference(variant, interpret=True)``:
  probabilities atol 0.02 and values atol 0.04 for the int8 variants (the
  repo's bar between int8 trunks), 0.03 and 0.05 for ``wide`` (the JAX
  package's bar for its bf16 trunks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from othello_reinforcement_learning_test_tpu.models import quantized as jq
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import (
    FusedInference as JaxFused,
    fold_block_params_wide as j_fold_wide,
    fused_trunk_int8,
    fused_trunk_wide,
)
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu_torch.kernels import build, conv_stages
from othello_reinforcement_learning_test_tpu_torch.kernels import trunk_int8_dx3 as dx3
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import (
    trunk_int8_dx3_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dxcat import (
    dxcat_kmajor,
    trunk_int8_dxcat,
    trunk_int8_dxcat_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_flat import (
    trunk_int8_flat,
    trunk_int8_flat_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8 import trunk_int8_plain
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_m9 import (
    m9_kmajor,
    trunk_int8_m9,
    trunk_int8_m9_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_patch import (
    patch_kmajor,
    trunk_int8_patch,
    trunk_int8_patch_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_matmul9 import (
    OFFSETS,
    conv3x3,
    sum_error_bound,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_wide import (
    conv_wide,
    conv_wide_plain,
    hwio,
    shifted_sum,
    tap_ulp_bound,
    trunk_wide,
    trunk_wide_plain,
    wide_taps,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import (
    DEFAULT_BLOCK_GAMES,
    INT8_KERNELS,
    FusedInference,
    dxcat_kmajor_weights,
    dxcat_weights,
    fold_block_params,
    fold_block_params_wide,
    m9_kmajor_weights,
    patch_kmajor_weights,
)
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from test_torch_trunk_int8 import fused_dequant_conv

NUM_BLOCKS, CHANNELS = 2, 32
INT8_VARIANTS = {"int8_m9": ("m9", trunk_int8_m9, trunk_int8_m9_plain),
                 "int8_patch": ("patch", trunk_int8_patch, trunk_int8_patch_plain),
                 "int8_flat": ("flat", trunk_int8_flat, trunk_int8_flat_plain),
                 "int8_dxcat": ("dxcat", trunk_int8_dxcat, trunk_int8_dxcat_plain)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op pool at one thread: the games here are long chains
    of tiny ops, which many threads per worker turn into spin-waits when
    the test workers share the cores (tens of times slower); one thread
    runs them as fast as eight does alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps of two non-negative bf16-valued f32 arrays."""
    return np.abs((a.view(np.int32) >> 16) - (b.view(np.int32) >> 16))


def port_model(variables, num_blocks=NUM_BLOCKS, num_filters=CHANNELS):
    m = OthelloResNet(num_blocks, num_filters)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m.eval()


def trunk_input(batch, seed=3):
    """A bf16 post-ReLU trunk input with a scale of its own per game, from a
    numpy seed."""
    rng = np.random.default_rng(batch + seed)
    h = np.abs(rng.standard_normal((batch, 8, 8, CHANNELS))) * rng.random((batch, 1, 1, 1)) * 2
    return jnp.asarray(h, jnp.float32).astype(jnp.bfloat16)


def to_torch_bf16(hb):
    return torch.from_numpy(np.array(hb.astype(jnp.float32))).to(torch.bfloat16)


def kernel_args(variant, variables, hb):
    """(the Pallas reference's output, the port wrapper's arguments) for the
    plain version of ``variant``, from the same variables and input."""
    x = to_torch_bf16(hb)
    if variant == "wide":
        jw, jb = j_fold_wide(variables, NUM_BLOCKS)
        ref = fused_trunk_wide(hb, jw, jb, NUM_BLOCKS, block_games=16, interpret=True)
        w, b = fold_block_params_wide(port_model(variables))
        return ref, (x, w, b)
    jqt = jq.quantize_trunk(variables, NUM_BLOCKS)
    ref = fused_trunk_int8(hb, jqt.w_int8, jqt.w_scale, jqt.bias, NUM_BLOCKS,
                           block_games=DEFAULT_BLOCK_GAMES[variant], interpret=True,
                           kernel=INT8_VARIANTS[variant][0])
    fused = FusedInference(port_model(variables), variant=variant)
    return ref, (x, fused.trunk_w, fused.trunk_scale, fused.trunk_bias)


@pytest.mark.parametrize("variant", ["wide", *INT8_VARIANTS])
@pytest.mark.parametrize("batch", [64, 24])  # bg 32 (wide: 16, dxcat: 64), and bg 8
def test_plain_trunk_matches_pallas_interpret(variant, batch):
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=3)
    ref, args = kernel_args(variant, variables, trunk_input(batch))
    plain = trunk_wide_plain if variant == "wide" else INT8_VARIANTS[variant][2]
    out = plain(*args).float().numpy()
    ref = np.array(ref.astype(jnp.float32))
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    assert bf16_ulps(out, ref).max() <= 1
    assert (out != ref).mean() < 1e-3


def test_dxcat_plain_matches_pallas_interpret_at_the_gate_batch(monkeypatch):
    """``int8_dxcat`` at the gate match's 40 games (bg 8). On this input one
    int8 code of the second block flips between the interpreted kernel, whose
    dequantisation XLA contracts into a multiply-add, and the plain version,
    which rounds product and sum apart as the CUDA kernel does (every other
    interpreted int8 kernel gives the interpreted dxcat's output here bit for
    bit). With that multiply-add emulated (``fused_dequant_conv``, as
    ``test_torch_trunk_int8.py``'s witness does) the plain version meets the
    bar of the other batches."""
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=3)
    ref, args = kernel_args("int8_dxcat", variables, trunk_input(40))
    ref = np.array(ref.astype(jnp.float32))
    monkeypatch.setattr(dx3, "int8_conv3x3",
                        lambda h, taps, offsets, s, b, bg, stage_bf16=False: fused_dequant_conv(
                            h, taps, offsets, s, b, bg))
    out = trunk_int8_dxcat_plain(*args).float().numpy()
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    assert bf16_ulps(out, ref).max() <= 1
    assert (out != ref).mean() < 1e-3


def test_fold_block_params_wide_matches_jax():
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=5)
    jw, jb = j_fold_wide(variables, NUM_BLOCKS)
    w, b = fold_block_params_wide(port_model(variables))
    assert w.dtype == torch.bfloat16 and w.shape == (2 * NUM_BLOCKS, CHANNELS, 9 * CHANNELS)
    np.testing.assert_array_equal(w.float().numpy(), np.array(jw.astype(jnp.float32)))
    # XLA may rewrite x / sqrt(y) as x * rsqrt(y): the biases agree to 1e-6
    np.testing.assert_allclose(b.numpy(), np.array(jb), atol=1e-6, rtol=0)
    # tap k = 3 * (dy + 1) + (dx + 1) of the HWIO fold sits in columns k*C..
    w9, _ = fold_block_params(port_model(variables))
    C = CHANNELS
    for k in range(9):
        assert torch.equal(w[:, :, k * C:(k + 1) * C], w9[:, k // 3, k % 3])


@pytest.mark.parametrize("variant", list(INT8_VARIANTS))
def test_int8_relayouts_match_jax(variant):
    """Each kernel's weights as ``fused_trunk_int8`` relays them out
    (``pallas_resnet.py:522-525`` for m9, ``:537-547`` for dxcat, ``:548-553``
    for patch and flat), relaid out K-major: tap k's (C_out, C_in) matrix is
    the transpose of that layout's tap-k block, taps in ``OFFSETS`` order;
    and ``FusedInference``'s ``trunk_w``."""
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=7)
    jqt = jq.quantize_trunk(variables, NUM_BLOCKS)
    L, C = 2 * NUM_BLOCKS, CHANNELS
    w_int8 = torch.from_numpy(np.array(jqt.w_int8))
    if variant == "int8_m9":
        jax_w = np.array(jqt.w_int8.reshape(L, C, 9, C).transpose(0, 2, 1, 3))
        want = m9_kmajor(torch.from_numpy(jax_w)).numpy()
        assert np.array_equal(m9_kmajor_weights(w_int8).numpy(), want)
        for k in range(9):  # tap k: the (C_in, C_out) matrix jax_w[:, k]
            np.testing.assert_array_equal(want[:, k], jax_w[:, k].transpose(0, 2, 1))
    elif variant == "int8_dxcat":
        jax_w = jqt.w_int8.reshape(L, C, 3, 3, C).transpose(0, 2, 3, 1, 4).reshape(L, 3, 3 * C, C)
        assert torch.equal(dxcat_weights(w_int8), torch.from_numpy(np.array(jax_w)))
        want = dxcat_kmajor(torch.from_numpy(np.array(jax_w))).numpy()
        assert np.array_equal(dxcat_kmajor_weights(w_int8).numpy(), want)
        for k, (dy, dx) in enumerate(OFFSETS):  # tap k: group dy, row block dx
            np.testing.assert_array_equal(
                want[:, k], np.array(jax_w)[:, 1 + dy, (1 + dx) * C:(2 + dx) * C].transpose(0, 2, 1))
    else:  # int8_patch and int8_flat: one (9C, C) layout
        jax_w = jqt.w_int8.reshape(L, C, 9, C).transpose(0, 2, 1, 3).reshape(L, 9 * C, C)
        want = patch_kmajor(torch.from_numpy(np.array(jax_w))).numpy()
        assert np.array_equal(patch_kmajor_weights(w_int8).numpy(), want)
        for k in range(9):  # tap k: rows [k*C, (k+1)*C)
            np.testing.assert_array_equal(
                want[:, k], np.array(jax_w)[:, k * C:(k + 1) * C].transpose(0, 2, 1))
    fused = FusedInference(port_model(variables), variant=variant)
    assert fused.trunk_w.dtype == torch.int8 and fused.trunk_w.is_contiguous()
    np.testing.assert_array_equal(fused.trunk_w.numpy(), np.array(want))
    assert INT8_KERNELS[variant][0] is INT8_VARIANTS[variant][1]


# the int8 conv body's variants (csrc/int8_conv_sm90.cuh, int32 sums): each
# plain version
CONV_BODY_PLAIN = {"int8_dx3": trunk_int8_dx3_plain, "int8": trunk_int8_plain,
                   "int8_patch": trunk_int8_patch_plain, "int8_m9": trunk_int8_m9_plain,
                   "int8_flat": trunk_int8_flat_plain}


@pytest.mark.parametrize("batch", [64, 24])
def test_conv_body_variants_agree_bit_for_bit(batch):
    """The five variants that run the int8 conv body compute one function:
    their plain versions on the same quantized weights, each relaid out by
    its variant's own function (``INT8_KERNELS``), at one block size (8
    games), give the same output bit for bit. A relayout in the wrong
    orientation would move the output."""
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=11)
    jqt = jq.quantize_trunk(variables, NUM_BLOCKS)
    w_int8 = torch.from_numpy(np.array(jqt.w_int8))
    scale = torch.from_numpy(np.array(jqt.w_scale))
    bias = torch.from_numpy(np.array(jqt.bias))
    x = to_torch_bf16(trunk_input(batch, seed=5))
    outs = {v: plain(x, INT8_KERNELS[v][1](w_int8), scale, bias, 8)
            for v, plain in CONV_BODY_PLAIN.items()}
    ref = outs["int8_dx3"]
    assert ref.shape == x.shape and bool(torch.isfinite(ref.float()).all())
    for v, out in outs.items():
        assert torch.equal(out, ref), v


@pytest.mark.parametrize("variant,probs,value", [
    ("wide", 0.03, 0.05), ("int8_m9", 0.02, 0.04), ("int8_patch", 0.02, 0.04),
    ("int8_flat", 0.02, 0.04), ("int8_dxcat", 0.02, 0.04)])
def test_fused_inference_matches_jax(variant, probs, value):
    num_blocks, batch = 2, 16
    variables = init_numpy_variables(num_blocks, 128, seed=13)
    jm = JaxResNet(num_blocks=num_blocks, num_filters=128)
    x = np.random.default_rng(batch).integers(0, 2, (batch, 8, 8, 3)).astype(np.float32)
    lp_j, v_j = JaxFused(jm, interpret=True, variant=variant)(variables, jnp.asarray(x))
    fused = FusedInference(port_model(variables, num_blocks, 128), variant=variant)
    lp_t, v_t = fused(torch.from_numpy(x))
    assert lp_t.shape == (batch, 65) and v_t.shape == (batch, 1)
    np.testing.assert_allclose(np.exp(lp_t.numpy()), np.exp(np.asarray(lp_j)), atol=probs,
                               rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=value, rtol=0)


def test_default_block_sizes_match_jax():
    jm = JaxResNet(num_blocks=1, num_filters=16)
    m = port_model(init_numpy_variables(1, 16, seed=0), 1, 16)
    for variant in JaxFused.VARIANTS:
        want = JaxFused(jm, variant=variant).block_games
        assert DEFAULT_BLOCK_GAMES[variant] == want, variant
        assert FusedInference(m, variant=variant).block_games == want, variant
        assert FusedInference(m, variant=variant, block_games=4).block_games == 4


@pytest.mark.parametrize("variant", list(INT8_VARIANTS))
def test_block_games_moves_an_int8_output(variant):
    """The activation scale is per block: 32 games in one block of 32 and in
    four blocks of 8 give different outputs, and a block of 8 depends only
    on its own games."""
    m = port_model(init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=3))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (32, 8, 8, 3))
                         .astype(np.float32))
    x[:8] *= 3  # the first block's inputs, and so its scale, are larger
    lp32, _ = FusedInference(m, variant=variant)(x)
    lp8, _ = FusedInference(m, variant=variant, block_games=8)(x)
    assert not torch.equal(lp32, lp8)
    alone, _ = FusedInference(m, variant=variant, block_games=8)(x[8:16])
    assert torch.equal(lp8[8:16], alone)


@pytest.mark.parametrize("variant", ["wide", *INT8_VARIANTS])
def test_wrapper_on_cpu_is_the_plain_version(variant):
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=3)
    _, args = kernel_args(variant, variables, trunk_input(24))
    wrapper, plain = ((trunk_wide, trunk_wide_plain) if variant == "wide"
                      else INT8_VARIANTS[variant][1:])
    before = wrapper.launches
    assert torch.equal(wrapper(*args), plain(*args))
    assert wrapper.launches == before
    x, w, *rest = args
    with pytest.raises(ValueError):  # weights of another layout
        wrapper(x, w.transpose(1, 2).contiguous(), *rest)
    with pytest.raises(ValueError):
        wrapper(x.float(), w, *rest)
    if variant == "wide":
        w, b = args[1:]
        h = args[0]
        assert torch.equal(conv_wide(h, w[0], b[0]), conv_wide_plain(h, w[0], b[0]))
        assert torch.equal(conv_wide(h, w[1], b[1], resid=h), conv_wide_plain(h, w[1], b[1], h))
        assert wrapper.launches == before


def test_wide_rounds_each_tap_to_bf16():
    """The wide trunk is not matmul9's: each tap's product is rounded to
    bf16 before the f32 sum, and one bf16 ulp of each, summed, bounds what
    that rounding may move."""
    variables = init_numpy_variables(NUM_BLOCKS, CHANNELS, seed=3)
    m = port_model(variables)
    w, b = fold_block_params_wide(m)
    h = to_torch_bf16(trunk_input(8))
    w9, _ = fold_block_params(m)
    unrounded = conv3x3(h, w9[0], b[0])
    rounded = shifted_sum(wide_taps(h, w[0]), b[0])
    diff = (unrounded - rounded).abs()
    assert float(diff.max()) > 0
    # each rounding moves a product by at most half an ulp; the f32
    # summation noise of the two sums comes on top
    assert bool((diff <= tap_ulp_bound(h, w[0]) / 2 + sum_error_bound(h, w9[0], b[0])).all())


def input_shifted_sum(h: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                      rounded: bool) -> torch.Tensor:
    """``bias + sum_k T(shift_k(h) @ w9_k)`` in f32, in ``OFFSETS`` order:
    the sum the CUDA conv body takes for both bf16 trunks, the shift on the
    input. T rounds each tap's product to bf16 (PyTorch's bf16 product: f32
    accumulation, one rounding) when ``rounded``, else keeps it in f32."""
    B, S, _, C = h.shape
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    acc = bias.expand(B * S * S, C)
    for dy, dx in OFFSETS:
        shifted = hp[:, 1 + dy:1 + dy + S, 1 + dx:1 + dx + S, :].reshape(-1, C)
        wk = w9[1 + dy, 1 + dx]
        z = (shifted @ wk).float() if rounded else shifted.float() @ wk.float()
        acc = acc + z
    return acc.reshape(B, S, S, C)


@pytest.mark.parametrize("channels,batch", [(128, 16), (CHANNELS, 64)])
def test_wide_conv_is_the_input_shifted_rounded_sum(channels, batch):
    """The identity the CUDA ``wide`` kernel relies on: rounding is
    elementwise and the shift only moves rows, so shifting the input and
    rounding each tap's product gives the wide conv (the Pallas kernel's
    rounded products shifted at the output) bit for bit; without the
    rounding the same sum is ``matmul9``'s conv, so one conv body serves
    both."""
    variables = init_numpy_variables(NUM_BLOCKS, channels, seed=3)
    w, b = fold_block_params_wide(port_model(variables, num_filters=channels))
    rng = np.random.default_rng(batch)
    h = np.abs(rng.standard_normal((batch, 8, 8, channels))) * rng.random((batch, 1, 1, 1)) * 2
    h = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16)
    for layer in range(2):
        w9 = hwio(w[layer])
        assert torch.equal(input_shifted_sum(h, w9, b[layer], rounded=True),
                           shifted_sum(wide_taps(h, w[layer]), b[layer]))
        assert torch.equal(input_shifted_sum(h, w9, b[layer], rounded=False),
                           conv3x3(h, w9, b[layer]))


@pytest.mark.parametrize("variant", list(conv_stages.VARIANTS))
def test_conv_stage_edits_apply_to_the_conv_body(variant):
    """``kernels/conv_stages.py`` times the bf16 conv body with stages taken
    out by text edits of its header: each edit still applies exactly once,
    and only ``full`` leaves the header as it is."""
    text = (build.CSRC_DIR / conv_stages.HEADER).read_text()
    edited = conv_stages.variant_header(text, conv_stages.VARIANTS[variant])
    assert (edited == text) == (variant == "full")


@pytest.mark.parametrize("variant", list(conv_stages.INT8_VARIANTS))
def test_conv_stage_edits_apply_to_the_int8_conv_body(variant):
    """The same for the int8 conv body: each edit of ``INT8_STAGE_EDITS``
    applies exactly once to its header, and only ``full`` leaves it as it
    is."""
    text = (build.CSRC_DIR / conv_stages.INT8_HEADER).read_text()
    edited = conv_stages.variant_header(text, conv_stages.INT8_VARIANTS[variant],
                                        conv_stages.INT8_STAGE_EDITS, conv_stages.INT8_HEADER)
    assert (edited == text) == (variant == "full")


@pytest.mark.parametrize("variant", list(conv_stages.TRUNK_VARIANTS))
def test_conv_stage_edits_apply_to_the_one_launch_trunk(variant):
    """The same for ``int8_dxcat``'s one-launch trunk (``--body dxcat``):
    each edit of ``TRUNK_STAGE_EDITS`` applies exactly once to its header,
    and only ``full`` leaves it as it is."""
    text = (build.CSRC_DIR / conv_stages.TRUNK_HEADER).read_text()
    edited = conv_stages.variant_header(text, conv_stages.TRUNK_VARIANTS[variant],
                                        conv_stages.TRUNK_STAGE_EDITS, conv_stages.TRUNK_HEADER)
    assert (edited == text) == (variant == "full")


def test_every_kernel_source_is_registered():
    """``chip_smoke.py`` builds ``build.SOURCES``: every ``csrc/*.cu``."""
    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
