"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA card. Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card every test skips. Tolerances:
- ``int8_dx3``, ``trunk_int8`` (both ``stage_bf16`` settings),
  ``int8_m9``, ``int8_patch``, ``int8_flat`` and ``int8_dxcat``: bit-exact (the plain
  versions repeat the kernels' arithmetic, and int32 sums are exact in any
  order); ``int8_dxcat`` also in 200 repeated forwards at B=64 and 40; the
  three bg-32 instances of the int8 conv body also taking turns on one
  weight tensor rewritten in place;
- ``random_step``: boards and ``live`` bit-exact against
  ``random_step_plain`` fed the same random words (integer work);
- ``leaf_step``: every output bit-exact against ``leaf_step_plain`` on the
  same tree (integer work; the features are 0 and 1), at sizes 8, 6 and 4
  under both rule sets; one search of 1,024 games through an engine behind
  a forwarding wrapper launches it once a simulation and equals the same
  search through the plain version, field by field;
- ``matmul9``: the whole trunk equal bit for bit to its 20 convs launched
  one by one (no atomics, a fixed summation order); each conv against the
  plain conv on the same input within
  PyTorch's bf16 default (rtol 1.6e-2, atol 1e-5) plus the f32 summation
  bound (``sum_error_bound``): the products are exact and only the order
  of the f32 sums differs, which near an output of zero alone exceeds
  1e-5. Through the 20 convs of a 10x128 tower such differences grow, as
  they do between any two summation orders, so the whole forward is held
  to the JAX package's ``matmul9`` bar (probs atol 0.03, value atol 0.05)
  with the trainer's initial weights;
- ``wide``: the whole trunk equal bit for bit to its 20 convs launched one
  by one; each conv against the plain conv on the same input within
  PyTorch's bf16 default plus ``sum_error_bound`` plus one bf16 ulp of each
  tap's product (``trunk_wide.conv_bound``): the tensor cores sum each
  tap's f32 dot in their own order, and an ulp of f32 there can move the
  product's bf16 rounding by one ulp.

The same bars hold every trunk at other board sides and widths (6x6 with 64
channels, 8x8 with 32, 4x4 with 16; ``matmul9``, ``int8_dx3`` and
``int8_dxcat`` also at widths that are no whole k32 step or whose weight
rows are below 128 bytes), past 128 channels where the kernels stream their
weights (8x8 with 256, and 4x4 with 144, 8x8 with 208, 6x6 with 176 for the
three bodies' trunks) and at a width that is no multiple of 16 (6x6 with 40, run at 48
with zero channels); the forward at 8x8 x 256 and 6x6 x 40 as at 6x6 x 64;
a shape outside the set the kernels take (past 256 channels, other board
sides) is refused before a launch. A resume of the trainer on the card,
across a wrap of its ring, equals the uninterrupted run bit for bit.

The program's spans (``utils/profiling.py``) and the device records of a
``torch.profiler`` session share a clock: a span around a kernel and the
wait for it holds the kernel's record, and the shortest edge on each side,
which bounds any offset between the clocks, is within 50 us. Over one
search of 1,024 games the walk's sync counter (``mcts._select.syncs``) is
at least the count of PyTorch's own sync checks.
"""

import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu_torch.kernels import leaf_step as ls
from othello_reinforcement_learning_test_tpu_torch.kernels import random_step as rs
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8 import (
    trunk_int8,
    trunk_int8_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import (
    trunk_int8_dx3,
    trunk_int8_dx3_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dxcat import (
    LAUNCHES_PER_FORWARD as DXCAT_LAUNCHES,
    trunk_int8_dxcat,
    trunk_int8_dxcat_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_flat import (
    trunk_int8_flat,
    trunk_int8_flat_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_m9 import (
    trunk_int8_m9,
    trunk_int8_m9_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_patch import (
    trunk_int8_patch,
    trunk_int8_patch_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_matmul9 import (
    conv_matmul9,
    conv_plain,
    sum_error_bound,
    trunk_matmul9,
    trunk_matmul9_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_wide import (
    conv_bound,
    conv_wide,
    conv_wide_plain,
    trunk_wide,
    trunk_wide_plain,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
    init_train_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.ops import fused_step
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.search import mcts
from othello_reinforcement_learning_test_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def fused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    m = OthelloResNet(10, 128)
    m.load_state_dict(from_jax_variables(init_numpy_variables(10, 128, seed=0)))
    return FusedInference(m.cuda().eval())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1024, 1040, 267, 24, 3, 1])  # 1040: bg 16, more games than CTAs
def test_trunk_kernel_matches_plain(fused, batch):
    rng = np.random.default_rng(batch)
    h = np.abs(rng.standard_normal((batch, 8, 8, 128))) * rng.random((batch, 1, 1, 1)) * 2
    x = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).cuda()
    args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias)
    before = trunk_int8_dx3.launches
    out = trunk_int8_dx3(x, *args)
    assert trunk_int8_dx3.launches == before + 20
    assert torch.equal(out, trunk_int8_dx3_plain(x, *args))


@pytest.mark.cuda
def test_fused_inference_kernel_matches_plain_trunk(fused):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (64, 8, 8, 3)).astype(np.float32))
    x = x.cuda()
    lp, v = fused(x)
    lp_p, v_p = fused.heads(trunk_int8_dx3_plain(fused.stem(x), fused.trunk_w,
                                                 fused.trunk_scale, fused.trunk_bias))
    assert torch.equal(lp, lp_p) and torch.equal(v, v_p)


@pytest.fixture(scope="module")
def fused_m9():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    m = OthelloResNet(10, 128)
    m.load_state_dict(from_jax_variables(init_train_variables(10, 128, seed=0)))
    return FusedInference(m.cuda(), variant="matmul9")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1024, 267, 24, 3, 1])
def test_matmul9_convs_match_plain(fused_m9, batch):
    x = torch.from_numpy(np.random.default_rng(batch).integers(0, 2, (batch, 8, 8, 3))
                         .astype(np.float32)).cuda()
    h = fused_m9.stem(x)
    w, b = fused_m9.trunk_w, fused_m9.trunk_bias
    before = trunk_matmul9.launches
    out = trunk_matmul9(h, w, b)
    torch.cuda.synchronize()
    assert trunk_matmul9.launches == before + 20
    assert out.shape == h.shape and bool(torch.isfinite(out.float()).all())
    # the kernel sums in a fixed order, so the trunk's loop (layer, residual,
    # conv 1 in place) must equal its 20 convs launched one by one
    chain = h
    for i in range(0, 20, 2):
        y = conv_matmul9(chain, w[i], b[i])
        chain = conv_matmul9(y, w[i + 1], b[i + 1], resid=chain)
    assert torch.equal(out, chain)

    def assert_conv_close(got, want, src, layer):
        diff = (got.float() - want.float()).abs()
        allowed = 1e-5 + 1.6e-2 * want.float().abs() + sum_error_bound(src, w[layer], b[layer])
        assert int((diff > allowed).sum()) == 0, f"conv {layer}: max diff {float(diff.max())}"

    for i in range(10):  # every conv on the plain chain's own inputs
        y = conv_plain(h, w[2 * i], b[2 * i])
        assert_conv_close(conv_matmul9(h, w[2 * i], b[2 * i]), y, h, 2 * i)
        h_next = conv_plain(y, w[2 * i + 1], b[2 * i + 1], h)
        assert_conv_close(conv_matmul9(y, w[2 * i + 1], b[2 * i + 1], resid=h), h_next, y,
                          2 * i + 1)
        h = h_next


@pytest.mark.cuda
def test_matmul9_fused_inference_matches_plain_trunk(fused_m9):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (256, 8, 8, 3))
                         .astype(np.float32)).cuda()
    lp, v = fused_m9(x)
    lp_p, v_p = fused_m9.heads(trunk_matmul9_plain(fused_m9.stem(x), fused_m9.trunk_w,
                                                   fused_m9.trunk_bias))
    torch.testing.assert_close(lp.exp(), lp_p.exp(), rtol=0, atol=0.03)
    torch.testing.assert_close(v, v_p, rtol=0, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["not_contiguous", "x_dtype", "w_dtype"])
def test_matmul9_wrapper_refuses_bad_input(fused_m9, bad):
    h = torch.zeros((4, 8, 8, 128), dtype=torch.bfloat16, device="cuda")
    w, b = fused_m9.trunk_w, fused_m9.trunk_bias
    if bad == "not_contiguous":
        h = torch.zeros((4, 8, 8, 256), dtype=torch.bfloat16, device="cuda")[..., ::2]
    elif bad == "x_dtype":
        h = h.float()
    else:
        w = w.float()
    before = trunk_matmul9.launches
    with pytest.raises(ValueError):
        trunk_matmul9(h, w, b)
    assert trunk_matmul9.launches == before


@pytest.fixture(scope="module")
def fused_int8():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    m = OthelloResNet(10, 128)
    m.load_state_dict(from_jax_variables(init_numpy_variables(10, 128, seed=1)))
    return FusedInference(m.cuda().eval(), variant="int8")


@pytest.mark.cuda
@pytest.mark.parametrize("stage_bf16", [False, True])
@pytest.mark.parametrize("batch", [1024, 1040, 267, 24, 3, 1])
def test_trunk_int8_matches_plain(fused_int8, batch, stage_bf16):
    rng = np.random.default_rng(batch)
    h = np.abs(rng.standard_normal((batch, 8, 8, 128))) * rng.random((batch, 1, 1, 1)) * 2
    x = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).cuda()
    args = (fused_int8.trunk_w, fused_int8.trunk_scale, fused_int8.trunk_bias)
    before = trunk_int8.launches
    out = trunk_int8(x, *args, stage_bf16=stage_bf16)
    assert trunk_int8.launches == before + 20
    assert torch.equal(out, trunk_int8_plain(x, *args, stage_bf16=stage_bf16))


@pytest.mark.cuda
def test_trunk_int8_refuses_other_shapes(fused_int8):
    """272 channels (past the 256 the streamed kernels take): refused before
    any launch, naming the shapes the kernels take."""
    C = 272
    x = torch.zeros((4, 8, 8, C), dtype=torch.bfloat16, device="cuda")
    args = (torch.zeros((2, 9, C, C), dtype=torch.int8, device="cuda"),
            torch.ones((2, C), device="cuda"), torch.zeros((2, C), device="cuda"))
    before = trunk_int8.launches
    with pytest.raises(ValueError, match="channel counts from 1 to 256"):
        trunk_int8(x, *args)
    assert trunk_int8.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("size,rules", [(8, "reference"), (8, "standard"), (6, "reference"),
                                        (6, "standard"), (4, "reference"), (4, "standard")])
def test_random_step_matches_plain(size, rules):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    s = get_engine(size, rules).initial_state((1024,), device="cuda")
    packed = fused_step.pack_boards(s.me, s.opp)
    gen = torch.Generator(device="cuda").manual_seed(size)
    live = torch.ones(1)
    while bool(live.any()):
        words = rs.draw_words(packed.shape[1:], gen)
        before = rs.random_step.launches
        new, live = rs.random_step(packed, words, size, rules)
        assert rs.random_step.launches == before + 1
        new_p, live_p = rs.random_step_plain(packed, words, size, rules)
        assert torch.equal(new.view(torch.int32), new_p.view(torch.int32))
        assert torch.equal(live, live_p)
        packed = new


@pytest.mark.cuda
def test_play_random_games_kernel_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    s = get_engine(8).initial_state((2048,), device="cuda")
    packed = fused_step.pack_boards(s.me, s.opp)
    gen = torch.Generator(device="cuda").manual_seed(0)
    drawn = []

    def draw(_):
        drawn.append(rs.draw_words(packed.shape[1:], gen))
        return drawn[-1]

    final, steps, plies = fused_step.play_random_games(packed, gen, words=draw)
    final_c, steps_c, plies_c = fused_step.play_random_games(
        packed.cpu(), None, words=lambda ply: drawn[ply].cpu())
    assert torch.equal(final.cpu().view(torch.int32), final_c.view(torch.int32))
    assert (steps, plies) == (steps_c, plies_c)


RULE_SETS = [(size, rules) for size in (8, 6, 4) for rules in ("reference", "standard")]


def dirty_allocator():
    """Leave the caching allocator's small blocks full of nonzero bytes, so
    that an output the kernel fails to write does not read as zero."""
    junk = [torch.full((1 << 18,), 0x5A, dtype=torch.uint8, device="cuda") for _ in range(32)]
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("size,rules", RULE_SETS)
@pytest.mark.parametrize("batch", [1024, 1040, 267, 3, 1])
def test_leaf_step_matches_plain(batch, size, rules):
    """Trees with ends of the game (action 0, invalid), parents that can
    only pass, and invalid actions (``leaf_step.sample_case``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    eng = get_engine(size, rules)
    case = ls.sample_case(size, rules, batch, 65, seed=batch + size, device="cuda")
    dirty_allocator()
    before = ls.leaf_step.launches
    child, *rest = ls.leaf_step(eng, *case)
    assert ls.leaf_step.launches == before + 1
    child_p, *rest_p = ls.leaf_step_plain(eng, *(t.cpu() for t in case))
    for got, want in zip((*child, *rest), (*child_p, *rest_p)):
        assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_search_steps_each_leaf_in_one_launch(fused, monkeypatch):
    """One search of 1,024 games with root noise through the int8 tower and
    an engine behind a forwarding wrapper (as ``azbench/run.py`` passes
    it): one kernel launch a simulation, and the result and tree of the
    same search through the plain version, field by field."""
    eng = get_engine(8)

    class Spanned:
        def __getattr__(self, name):
            return getattr(eng, name)

        def observe(self, *a, **k):
            return eng.observe(*a, **k)

        def step(self, *a, **k):
            return eng.step(*a, **k)

    gen = torch.Generator(device="cuda").manual_seed(1)
    boards = eng.initial_state((1024,), device="cuda")
    for _ in range(6):  # roots a few random plies in
        legal = eng.legal_actions(boards).to(torch.float32)
        boards, _ = eng.step(boards, torch.multinomial(legal, 1, generator=gen)[:, 0])

    def search():
        gen.manual_seed(2)
        return mcts.search(Spanned(), fused, boards, 64, c_puct=1.25, add_noise=True,
                           generator=gen, return_tree=True)

    before = ls.leaf_step.launches
    result, tree = search()
    assert ls.leaf_step.launches == before + 64
    monkeypatch.setattr(mcts, "leaf_step", ls.leaf_step_plain)
    result_p, tree_p = search()
    assert ls.leaf_step.launches == before + 64
    for got, want in zip(result, result_p):
        assert torch.equal(got, want)
    for name in vars(tree):
        assert torch.equal(getattr(tree, name), getattr(tree_p, name)), name
    assert int(tree.num_nodes.max()) > 2


INT8_KERNELS = {"int8_m9": (trunk_int8_m9, trunk_int8_m9_plain),
                "int8_patch": (trunk_int8_patch, trunk_int8_patch_plain),
                "int8_flat": (trunk_int8_flat, trunk_int8_flat_plain),
                "int8_dxcat": (trunk_int8_dxcat, trunk_int8_dxcat_plain)}


# int8_dxcat launches the whole trunk at once; the others once a conv
LAUNCHES_PER_FORWARD = {"int8_dxcat": DXCAT_LAUNCHES}
# the redesigned kernels at chip_smoke.py's batches: int8_dxcat also at the
# gated iteration's 64 (self-play) and 40 (the gate match, bg 8)
BODY_BATCHES = (1024, 1040, 267, 24, 3, 1)
REDESIGNED_BATCHES = [(v, b) for v, bs in (("int8_m9", BODY_BATCHES),
                                           ("int8_patch", BODY_BATCHES),
                                           ("int8_flat", BODY_BATCHES),
                                           ("int8_dxcat", (64, 40) + BODY_BATCHES))
                      for b in bs]


@pytest.fixture(scope="module")
def int8_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    m = OthelloResNet(10, 128)
    m.load_state_dict(from_jax_variables(init_numpy_variables(10, 128, seed=2)))
    return m.cuda().eval()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(INT8_KERNELS))
@pytest.mark.parametrize("batch", [1024, 24, 3, 1])
def test_int8_variant_kernels_match_plain(int8_model, variant, batch):
    fused = FusedInference(int8_model, variant=variant)
    kernel, plain = INT8_KERNELS[variant]
    rng = np.random.default_rng(batch)
    h = np.abs(rng.standard_normal((batch, 8, 8, 128))) * rng.random((batch, 1, 1, 1)) * 2
    x = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).cuda()
    args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias)
    before = kernel.launches
    out = kernel(x, *args)
    assert kernel.launches == before + LAUNCHES_PER_FORWARD.get(variant, 20)
    assert torch.equal(out, plain(x, *args))
    xb = torch.from_numpy(rng.integers(0, 2, (batch, 8, 8, 3)).astype(np.float32)).cuda()
    lp, v = fused(xb)
    lp_p, v_p = fused.heads(plain(fused.stem(xb), *args))
    assert torch.equal(lp, lp_p) and torch.equal(v, v_p)


def post_relu_input(batch: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    h = np.abs(rng.standard_normal((batch, 8, 8, 128))) * rng.random((batch, 1, 1, 1)) * 2
    return torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("variant,batch", REDESIGNED_BATCHES)
def test_redesigned_int8_kernels_match_plain(int8_model, variant, batch):
    """The wgmma ``int8_m9``, ``int8_patch`` and ``int8_flat`` (the conv body
    at bg 32) and the one-launch ``int8_dxcat`` trunk, bit for bit, at every
    batch chip_smoke.py checks (1040: bg 16 and more games than CTAs; 267:
    an odd count)."""
    fused = FusedInference(int8_model, variant=variant)
    kernel, plain = INT8_KERNELS[variant]
    x = post_relu_input(batch, batch + 1)
    args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias)
    before = kernel.launches
    out = kernel(x, *args)
    assert kernel.launches == before + LAUNCHES_PER_FORWARD.get(variant, 20)
    assert torch.equal(out, plain(x, *args))


@pytest.mark.cuda
def test_conv_body_libraries_take_new_weights_at_one_address(int8_model):
    """Three libraries instantiate the int8 conv body at bg 32 (``int8_m9``,
    ``int8_patch``, ``int8_flat``), each with its own cache of weight maps
    keyed on the weights' address. Taking turns on one weight tensor whose
    contents are rewritten in place between calls, each kernel still equals
    its plain version on the new weights."""
    fused = FusedInference(int8_model, variant="int8_patch")
    w = fused.trunk_w.clone()
    args = (fused.trunk_scale, fused.trunk_bias)
    x = post_relu_input(64, 9)
    for step in range(2):
        if step:
            w.copy_(w.flip(2))  # other weights, the same address
        for variant in ("int8_m9", "int8_patch", "int8_flat"):
            kernel, plain = INT8_KERNELS[variant]
            assert torch.equal(kernel(x, w, *args), plain(x, w, *args)), (variant, step)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 40])
def test_dxcat_repeats_match_plain(int8_model, batch):
    """200 forwards of the one-launch trunk at the gated iteration's
    batches, each equal to the plain version: a missing fence across the
    grid barrier would show as a rare wrong int8 code."""
    fused = FusedInference(int8_model, variant="int8_dxcat")
    args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias)
    x = post_relu_input(batch, 7)
    want = trunk_int8_dxcat_plain(x, *args)
    bad = sum(not torch.equal(trunk_int8_dxcat(x, *args), want) for _ in range(200))
    assert bad == 0


@pytest.mark.cuda
@pytest.mark.parametrize("num_blocks", [1, 3])
@pytest.mark.parametrize("batch", [64, 200])  # channels split across CTAs; whole games
def test_dxcat_other_depths_match_plain(num_blocks, batch):
    """The one-launch trunk at other depths (its weight buffers, barriers and
    prefetch count layers), in both of its modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    m = OthelloResNet(num_blocks, 128)
    m.load_state_dict(from_jax_variables(init_numpy_variables(num_blocks, 128, seed=4)))
    fused = FusedInference(m.cuda().eval(), variant="int8_dxcat")
    args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias)
    x = post_relu_input(batch, num_blocks)
    assert torch.equal(trunk_int8_dxcat(x, *args), trunk_int8_dxcat_plain(x, *args))


@pytest.fixture(scope="module")
def fused_wide():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    m = OthelloResNet(10, 128)
    m.load_state_dict(from_jax_variables(init_train_variables(10, 128, seed=0)))
    return FusedInference(m.cuda(), variant="wide")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1024, 267, 24, 3, 1])
def test_wide_convs_match_plain(fused_wide, batch):
    x = torch.from_numpy(np.random.default_rng(batch).integers(0, 2, (batch, 8, 8, 3))
                         .astype(np.float32)).cuda()
    h = fused_wide.stem(x)
    w, b = fused_wide.trunk_w, fused_wide.trunk_bias
    before = trunk_wide.launches
    out = trunk_wide(h, w, b)
    torch.cuda.synchronize()
    assert trunk_wide.launches == before + 20
    assert out.shape == h.shape and bool(torch.isfinite(out.float()).all())
    chain = h
    for i in range(0, 20, 2):
        y = conv_wide(chain, w[i], b[i])
        chain = conv_wide(y, w[i + 1], b[i + 1], resid=chain)
    assert torch.equal(out, chain)
    for i in range(10):  # every conv on the plain chain's own inputs
        y = conv_wide_plain(h, w[2 * i], b[2 * i])
        got = conv_wide(h, w[2 * i], b[2 * i])
        assert bool(((got.float() - y.float()).abs() <= conv_bound(h, w[2 * i], b[2 * i], y)).all())
        h_next = conv_wide_plain(y, w[2 * i + 1], b[2 * i + 1], h)
        got = conv_wide(y, w[2 * i + 1], b[2 * i + 1], resid=h)
        bound = conv_bound(y, w[2 * i + 1], b[2 * i + 1], h_next)
        assert bool(((got.float() - h_next.float()).abs() <= bound).all())
        h = h_next


@pytest.mark.cuda
def test_wide_fused_inference_matches_plain_trunk(fused_wide):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (256, 8, 8, 3))
                         .astype(np.float32)).cuda()
    lp, v = fused_wide(x)
    lp_p, v_p = fused_wide.heads(trunk_wide_plain(fused_wide.stem(x), fused_wide.trunk_w,
                                                  fused_wide.trunk_bias))
    torch.testing.assert_close(lp.exp(), lp_p.exp(), rtol=0, atol=0.03)
    torch.testing.assert_close(v, v_p, rtol=0, atol=0.05)


# -- other board sides and widths ---------------------------------------------

# (board side, channels) every trunk is checked at, and the widths whose
# K (16, 48, 80, 112: not a whole k32 step), weight panels (below 128-byte
# rows) or one-launch split differ, for the three bodies' trunks
MAIN_SHAPES = [(6, 64), (8, 32), (4, 16), (8, 256), (6, 40)]
ODD_SHAPES = [(6, 48), (4, 80), (8, 96), (6, 112), (4, 128), (8, 16), (4, 144), (8, 208),
              (6, 176)]
BODY_TRUNKS = ("matmul9", "int8_dx3", "int8_dxcat")
ALL_TRUNKS = ("matmul9", "wide", "int8", "int8_bf16", "int8_m9", "int8_patch", "int8_flat",
              "int8_dx3", "int8_dxcat")
SHAPE_CASES = [(v, s, c) for v in ALL_TRUNKS for s, c in MAIN_SHAPES] \
    + [(v, s, c) for v in BODY_TRUNKS for s, c in ODD_SHAPES]
WRAPPERS = {"matmul9": trunk_matmul9, "wide": trunk_wide, "int8": trunk_int8,
            "int8_bf16": trunk_int8, "int8_dx3": trunk_int8_dx3, **{
                v: k for v, (k, _) in INT8_KERNELS.items()}}


@pytest.fixture(scope="module")
def shaped():
    """(variant, S, C) -> FusedInference of a 2-block network at that shape
    (weights from a numpy seed: the trainer's initial ones for the bf16
    trunks, He-normal for the int8), every library these tests use built
    first, one nvcc each, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    from concurrent.futures import ThreadPoolExecutor

    from othello_reinforcement_learning_test_tpu_torch.kernels import build

    jobs = sorted({(WRAPPERS[v].__name__, (s, c)) for v, s, c in SHAPE_CASES})
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build.build(*job), jobs))
    cache = {}

    def get(variant, size, channels):
        if (variant, size, channels) not in cache:
            init = init_train_variables if variant in ("matmul9", "wide") else init_numpy_variables
            m = OthelloResNet(2, channels, size)
            m.load_state_dict(from_jax_variables(init(2, channels, seed=size + channels,
                                                      board_size=size)))
            cache[variant, size, channels] = FusedInference(m.cuda().eval(), variant=variant)
        return cache[variant, size, channels]
    return get


def shaped_input(batch: int, size: int, channels: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    h = np.abs(rng.standard_normal((batch, size, size, channels))) \
        * rng.random((batch, 1, 1, 1)) * 2
    return torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 24, 1, 200])  # 200: more games than SMs
@pytest.mark.parametrize("variant,size,channels", SHAPE_CASES)
def test_trunks_at_other_shapes_match_plain(shaped, variant, size, channels, batch):
    """Each trunk at other board sides and widths against its plain version:
    the int8 ones bit for bit; the bf16 ones equal to their convs launched
    one by one, each conv within the bar of the 8x8 tests above. Launches
    L a forward (int8_dxcat: 1)."""
    fused = shaped(variant, size, channels)
    kernel = WRAPPERS[variant]
    x = shaped_input(batch, size, channels, batch + size + channels)
    w, b = fused.trunk_w, fused.trunk_bias
    before = kernel.launches
    if variant in ("matmul9", "wide"):
        conv, conv_ref = (conv_matmul9, conv_plain) if variant == "matmul9" \
            else (conv_wide, conv_wide_plain)
        out = kernel(x, w, b)
        assert kernel.launches == before + 4
        chain = x
        for i in range(0, 4, 2):
            y = conv(chain, w[i], b[i])
            chain = conv(y, w[i + 1], b[i + 1], resid=chain)
        assert torch.equal(out, chain)
        h = x
        for i in range(4):  # every conv on the plain chain's own inputs
            resid, src = (h, y) if i % 2 else (None, h)
            want = conv_ref(src, w[i], b[i], resid)
            got = conv(src, w[i], b[i], resid)
            if variant == "matmul9":
                bound = 1e-5 + 1.6e-2 * want.float().abs() + sum_error_bound(src, w[i], b[i])
            else:
                bound = conv_bound(src, w[i], b[i], want)
            assert bool(((got.float() - want.float()).abs() <= bound).all()), (i, batch)
            h, y = (want, y) if i % 2 else (h, want)
    else:
        args = (w, fused.trunk_scale, b)
        kw = {"stage_bf16": True} if variant == "int8_bf16" else {}
        out = kernel(x, *args, **kw)
        assert kernel.launches == before + LAUNCHES_PER_FORWARD.get(variant, 4)
        plain = trunk_int8_plain if variant in ("int8", "int8_bf16") else (
            trunk_int8_dx3_plain if variant == "int8_dx3" else INT8_KERNELS[variant][1])
        assert torch.equal(out, plain(x, *args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("size,channels", [(6, 64), (8, 256), (6, 40)])
@pytest.mark.parametrize("variant", ALL_TRUNKS)
def test_fused_inference_at_6x6_matches_plain_trunk(shaped, variant, size, channels):
    """The debug_6x6 width (64 channels), 256 channels at 8x8 and 40 at 6x6
    (weights padded to 48 once) through FusedInference: the int8 trunks
    equal to the plain trunk's forward, the bf16 ones within the JAX
    package's bar (probs 0.03, value 0.05)."""
    fused = shaped(variant, size, channels)
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 2, (64, size, size, 3))
                         .astype(np.float32)).cuda()
    lp, v = fused(x)
    plain = {"matmul9": trunk_matmul9_plain, "wide": trunk_wide_plain}
    h = fused.stem(x)
    if variant in plain:
        lp_p, v_p = fused.heads(plain[variant](h, fused.trunk_w, fused.trunk_bias))
        torch.testing.assert_close(lp.exp(), lp_p.exp(), rtol=0, atol=0.03)
        torch.testing.assert_close(v, v_p, rtol=0, atol=0.05)
    else:
        kw = {"stage_bf16": True} if variant == "int8_bf16" else {}
        plain = trunk_int8_plain if variant in ("int8", "int8_bf16") else (
            trunk_int8_dx3_plain if variant == "int8_dx3" else INT8_KERNELS[variant][1])
        lp_p, v_p = fused.heads(plain(h, fused.trunk_w, fused.trunk_scale, fused.trunk_bias,
                                      **kw))
        assert torch.equal(lp, lp_p) and torch.equal(v, v_p)
    assert lp.shape == (64, size * size + 1) and v.shape == (64, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ALL_TRUNKS)
@pytest.mark.parametrize("size,channels", [(8, 272), (5, 64), (6, 512)])
def test_trunks_refuse_other_shapes_before_a_launch(variant, size, channels):
    """Shapes outside the set: a ValueError naming it, no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    C, kernel = channels, WRAPPERS[variant]
    x = torch.zeros((4, size, size, C), dtype=torch.bfloat16, device="cuda")
    b = torch.zeros((2, C), device="cuda")
    if variant in ("matmul9", "wide"):
        tail = (3, 3, C, C) if variant == "matmul9" else (C, 9 * C)
        args = (torch.zeros((2, *tail), dtype=torch.bfloat16, device="cuda"), b)
    else:
        args = (torch.zeros((2, 9, C, C), dtype=torch.int8, device="cuda"),
                torch.ones((2, C), device="cuda"), b)
    before = kernel.launches
    with pytest.raises(ValueError, match="board sides 4, 6, 8 and channel counts"):
        kernel(x, *args)
    assert kernel.launches == before



@pytest.mark.cuda
def test_resume_across_a_ring_wrap_on_the_card(tmp_path):
    """``test_torch_learning.py::test_resume_across_a_ring_wrap`` on the
    card at the trainer's bf16 compute: a resume after iteration 1, across
    a wrap of the ring, equal bit for bit to the uninterrupted run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the run trains on it")
    from torch_resume import assert_resume_equal, run_and_resume

    a, b, resumed_plies = run_and_resume(tmp_path, "auto")
    assert a.device.type == "cuda"
    assert_resume_equal(a, b, resumed_plies)


@pytest.mark.cuda
def test_program_spans_share_the_device_trace_clock():
    """Spans around a sleep kernel and the wait for it hold its device
    record: each kernel starts after its span opens and ends before it
    closes. An offset between the clocks would move every opening edge one
    way and every closing edge the other; the host's launch and wait only
    lengthen them, so the shortest of each bounds the offset: both within
    50 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace is the card's")
    from torch.profiler import ProfilerActivity, profile

    probes = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(256):  # a session loses device records at its start
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        with profiling.tracing() as rec:
            for _ in range(probes):
                with profiling.span("probe.sleep"):
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and "spin_kernel" in e.name() and e.duration_ns() > 100_000)
    assert len(kernels) == len(rec.spans) == probes
    opened = [k0 - s.start_ns for s, (k0, _) in zip(rec.spans, kernels)]
    closed = [s.end_ns - k1 for s, (_, k1) in zip(rec.spans, kernels)]
    print("span opened before its kernel (us):", [round(t / 1e3, 1) for t in opened])
    print("span closed after its kernel (us):", [round(t / 1e3, 1) for t in closed])
    assert min(opened) >= 0 and min(closed) >= 0
    assert min(opened) <= 50_000 and min(closed) <= 50_000


@pytest.mark.cuda
def test_select_sync_counter_covers_pytorchs_own_count(fused):
    """One search of 1,024 games through the int8 tower: the syncs the walk
    counts are at least those PyTorch's sync checks report."""
    import warnings

    eng = get_engine(8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    boards = eng.initial_state((1024,), device="cuda")
    for _ in range(6):  # roots a few random plies in
        legal = eng.legal_actions(boards).to(torch.float32)
        boards, _ = eng.step(boards, torch.multinomial(legal, 1, generator=gen)[:, 0])

    def search():
        return mcts.search(eng, fused, boards, 64, c_puct=1.25, add_noise=True, generator=gen)

    search()
    torch.cuda.synchronize()
    mcts._select.syncs = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            search()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reported = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    print(f"walk syncs counted {mcts._select.syncs}, PyTorch reports {reported}")
    assert reported > 0 and mcts._select.syncs >= reported
