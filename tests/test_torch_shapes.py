"""The port's trunks at the board sides and widths other than 8x8 and 128
channels that the JAX trunks run, against the JAX package on the CPU:

- each of the plain trunks (``matmul9``, ``wide``, ``int8``, ``int8_bf16``,
  ``int8_m9``, ``int8_patch``, ``int8_flat``, ``int8_dx3``, ``int8_dxcat``) at
  6x6 with 64 channels (1 block, B=24) and 4x4 with 16 (2 blocks, B=64)
  against the JAX Pallas kernel in interpret mode, as
  ``test_torch_trunk_variants.py`` holds them at 8x8: at most one bf16 ulp
  apart, and fewer than 1e-3 of the values differing;
- ``play_games`` at 6x6 through ``int8_dx3`` (2 blocks x 16 channels)
  against JAX ``play_games`` with the JAX ``FusedInference``, game for game;
- the shape check the CUDA trunks share (``kernels/build.py``): every board
  side 4, 6, 8 with every multiple of 16 up to 256 channels and widths
  between them (8, 40, 200; built at the next multiple of 16) accepted,
  other sides and widths (0, past 256) refused, and a library only ever
  built at a shape;
- the port's ``bench --mode mcts`` at the ``debug_6x6`` network (6x6, 5x64)
  through ``int8_dx3`` on the CPU.

The CUDA kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase ``shapes``);
8x8 with 256 channels, widths that are no multiple of 16 and the numpy
reference of the int8 trunk are ``tests/test_torch_wide.py``'s.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models import quantized as jq
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import (
    FusedInference as JaxFused,
    fold_block_params as j_fold,
    fold_block_params_wide as j_fold_wide,
    fused_trunk,
    fused_trunk_int8,
    fused_trunk_wide,
)
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.train import self_play as jsp
from othello_reinforcement_learning_test_tpu_torch import bench
from othello_reinforcement_learning_test_tpu_torch.kernels import build
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import (
    DEFAULT_BLOCK_GAMES,
    FusedInference,
)
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.train import self_play as tsp
from test_torch_selfplay import assert_same_trajectory

# the JAX fused_trunk_int8 kernel of each int8 variant
JAX_INT8_KERNEL = {"int8": "out_shift", "int8_bf16": "out_shift_bf16", "int8_m9": "m9",
                   "int8_patch": "patch", "int8_flat": "flat", "int8_dx3": "dx3",
                   "int8_dxcat": "dxcat"}
TRUNK_VARIANTS = ("matmul9", "wide", *JAX_INT8_KERNEL)
# (board side, channels, blocks, batch)
SHAPE_CASES = [(6, 64, 1, 24), (4, 16, 2, 64)]


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


def jax_trunk(variant, variables, hb, num_blocks):
    """The JAX Pallas trunk of ``variant`` in interpret mode, at the block
    size the port's FusedInference takes for it."""
    bg = DEFAULT_BLOCK_GAMES[variant]
    if variant == "matmul9":
        w, b = j_fold(variables, num_blocks)
        return fused_trunk(hb, w, b, num_blocks, block_games=bg, interpret=True)
    if variant == "wide":
        w, b = j_fold_wide(variables, num_blocks)
        return fused_trunk_wide(hb, w, b, num_blocks, block_games=bg, interpret=True)
    qt = jq.quantize_trunk(variables, num_blocks)
    return fused_trunk_int8(hb, qt.w_int8, qt.w_scale, qt.bias, num_blocks, block_games=bg,
                            interpret=True, kernel=JAX_INT8_KERNEL[variant])


@pytest.mark.parametrize("size,channels,num_blocks,batch", SHAPE_CASES)
@pytest.mark.parametrize("variant", TRUNK_VARIANTS)
def test_plain_trunk_matches_pallas_interpret_at_other_shapes(variant, size, channels,
                                                              num_blocks, batch):
    variables = init_numpy_variables(num_blocks, channels, seed=5, board_size=size)
    rng = np.random.default_rng(batch + size)
    h = np.abs(rng.standard_normal((batch, size, size, channels))) \
        * rng.random((batch, 1, 1, 1)) * 2
    hb = jnp.asarray(h, jnp.float32).astype(jnp.bfloat16)
    ref = np.array(jax_trunk(variant, variables, hb, num_blocks).astype(jnp.float32))
    m = OthelloResNet(num_blocks, channels, size)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    fused = FusedInference(m.eval(), variant=variant)
    x = torch.from_numpy(np.array(hb.astype(jnp.float32))).to(torch.bfloat16)
    out = fused.trunk(x).float().numpy()
    assert out.shape == ref.shape == (batch, size, size, channels)
    assert np.all(np.isfinite(out))
    assert bf16_ulps(out, ref).max() <= 1
    assert (out != ref).mean() < 1e-3


def test_play_games_at_6x6_matches_jax_with_int8_dx3():
    """Self-play at 6x6 through FusedInference (int8_dx3) at 2 blocks x 16
    against JAX ``play_games`` with the JAX FusedInference (int8_dx3, Pallas
    in interpret mode), run unfused as a host callback as
    ``test_torch_selfplay.py`` does at 8x8: every trajectory field equal."""
    size, games = 6, 3
    variables = init_numpy_variables(2, 16, seed=23, board_size=size)
    jfused = JaxFused(JaxResNet(num_blocks=2, num_filters=16, board_size=size), interpret=True,
                      variant="int8_dx3")
    actions = size * size + 1

    def host_net(x):
        lp, v = jfused(variables, jnp.asarray(x))
        return np.asarray(lp), np.asarray(v)

    def jax_net(_, x):
        shapes = (jax.ShapeDtypeStruct((games, actions), jnp.float32),
                  jax.ShapeDtypeStruct((games, 1), jnp.float32))
        return jax.pure_callback(host_net, shapes, x)

    jt = jsp.play_games(jbb.get_engine(size), jax_net, {}, jax.random.PRNGKey(0),
                        num_games=games, num_simulations=4, temperature_threshold=0,
                        add_noise=False)
    m = OthelloResNet(2, 16, size)
    m.load_state_dict(from_jax_variables(variables))
    forwards = []
    fused = FusedInference(m.eval(), variant="int8_dx3")

    def net(x):
        forwards.append(x.shape)
        return fused(x)

    tt = tsp.play_games(get_engine(size), net, games, 4, temperature_threshold=0,
                        add_noise=False, device="cpu")
    assert forwards and all(s == (games, size, size, 3) for s in forwards)
    assert_same_trajectory(tt, jt)


@pytest.mark.parametrize("channels", [*range(16, 257, 16), 8, 40, 200])
@pytest.mark.parametrize("size", [4, 6, 8])
def test_trunk_shape_check_accepts(size, channels):
    """Every multiple of 16 up to 256 and widths between them: the library
    is built at the width rounded up to 16."""
    build.check_trunk_shape(size, channels)
    padded = -(-channels // 16) * 16
    assert build.padded_channels(channels) == padded
    assert build.trunk_shape(torch.empty(2, size, size, channels)) == (size, padded)


@pytest.mark.parametrize("size,channels", [(8, 272), (8, 0), (8, 512), (6, 512), (4, 257),
                                           (6, 1024), (5, 64), (10, 64), (5, 16), (10, 128)])
def test_trunk_shape_check_refuses(size, channels):
    """C in {0, 257, 272, 512, 1024} and S in {5, 10}: refused with the
    allowed set named, and no library is built at such a shape."""
    with pytest.raises(ValueError, match=r"board sides 4, 6, 8 and channel counts from 1 "
                                         r"to 256"):
        build.check_trunk_shape(size, channels)
    with pytest.raises(ValueError, match="board sides 4, 6, 8"):
        build.trunk_shape(torch.empty(2, size, size, channels))
    with pytest.raises(ValueError, match="board sides 4, 6, 8"):
        build.build("trunk_int8_dx3", (size, channels))


def test_libraries_are_built_at_a_shape_or_none():
    """A trunk source is a template built at a shape; random_step has none."""
    with pytest.raises(ValueError, match="trunk_matmul9 is built with a shape"):
        build.build("trunk_matmul9")
    with pytest.raises(ValueError, match="random_step is built without a shape"):
        build.build("random_step", (8, 128))


def test_bench_mcts_at_the_debug_6x6_network(monkeypatch):
    """``bench --mode mcts --size 6 --filters 64 --blocks 5 --net-variant
    int8_dx3 --device cpu`` at a tiny batch: its JSON line, every forward
    through the fused trunk at 6x6 x 64 channels."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    shapes = []
    trunk = FusedInference.trunk

    def counted(self, h):
        shapes.append((self.variant, tuple(h.shape[1:])))
        return trunk(self, h)

    monkeypatch.setattr(FusedInference, "trunk", counted)
    line = bench.run(["--mode", "mcts", "--size", "6", "--filters", "64", "--blocks", "5",
                      "--net-variant", "int8_dx3", "--device", "cpu", "--batch", "4",
                      "--repeats", "1", "--simulations", "2"])
    assert line["metric"] == "mcts_selfplay_games_per_sec" and line["device"] == "cpu"
    assert line["model"] == "5x64" and line["net_variant"] == "int8_dx3"
    assert line["batch"] == 4 and line["value"] > 0
    assert line["avg_moves"] > 0
    assert shapes and set(shapes) == {("int8_dx3", (6, 6, 64))}
