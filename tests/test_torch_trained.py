"""The repo's trained networks in the port (``..._torch/trained/``), on the CPU.

Three trained 10x128 JAX checkpoints of ``results/`` carried into the
port with ``scripts/orbax_to_torch.py`` and committed with
``MANIFEST.json``: ``trained.NAMES`` (the flagship r5 network and the
500-iteration one) and ``trained.STUDY_NAMES`` (flagship r4, which the
strength studies play). Items 1 and 2 hold all three, items 3 and 4 the
two of ``NAMES``:

1. each committed ``.pt`` equals a fresh conversion of its orbax directory
   tensor for tensor; its sha256, step and iteration are the manifest's, its
   config sidecar the JAX one; every record the manifest quotes equals the
   file and key it names; the record copies under ``trained/records/``
   equal the JAX records;
2. the port's bf16 forward (``MCTSPlayer.from_checkpoint(...,
   device="cpu")``) against the JAX ``apply_eval`` on the same weights, on
   256 positions after 20 uniform random plies from ``default_rng(0)``: the
   top legal move agrees at >= 0.98 of them, probabilities within 0.03 and
   the value within 0.05 (the port's forward bars). ``apply_eval`` is called
   op by op, as the JAX package's checkpoint tests call it: jitted, XLA's
   CPU compiler fuses the BatchNorm's multiply and add, and on these sharp
   policies that alone moves a probability by 0.033 (500iter; printed with
   ``-s``), more than the port departs from either;
3. each of the ten ``FusedInference`` variants, through its plain version,
   against the port's bf16 forward on the first 64 of those positions
   (a plain int8 forward at 256 takes about 5 s on one thread): top-move
   agreement >= 0.9 and value correlation > 0.95, the JAX package's bars for
   quantized inference (``tests/test_int8_strength.py``);
4. where the int8 departure from the JAX package comes from, on trained
   weights: flagship r5's folded, quantized trunk, one trunk input (the
   port's stem output at B=64) for every trunk. The JAX ``quantize_trunk``
   equals the port's; ``numpy_int8_trunk`` (``tests/test_torch_wide.py``)
   with XLA's two CPU rewrites (the activation scale's ``/ 127`` as a
   multiplication by the reciprocal, the dequantisation as one multiply-add)
   equals the interpreted Pallas ``int8_dx3`` trunk and the jitted
   ``int8_xla`` trunk bit for bit, and without them the port's plain
   ``int8_dx3`` and ``int8_xla`` trunks (at B=64 the one block of
   ``int8_dx3`` is the batch, as the one scale of ``int8_xla`` is).

   Before the port's BatchNorm fold took its square root correctly rounded
   (``models/fused_resnet.py::_bn_affine``), PyTorch's CPU ``sqrt`` put one
   channel of this network an ulp off, moving two folded bf16 weights and
   nine biases: the quantized trunks departed from the JAX package by more
   than the rewrites. With ``-s`` the test prints the top-move agreement of
   the port's heads on each JAX trunk against the port's own forward.
"""

import functools
import hashlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models import quantized as jq
from othello_reinforcement_learning_test_tpu.models import resnet as jresnet
from othello_reinforcement_learning_test_tpu.models.pallas_resnet import fused_trunk_int8
from othello_reinforcement_learning_test_tpu.train import trainer as jtrainer
from othello_reinforcement_learning_test_tpu_torch import trained
from othello_reinforcement_learning_test_tpu_torch.evaluation.players import MCTSPlayer
from othello_reinforcement_learning_test_tpu_torch.models.convert import from_jax_variables
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import (
    PORTED_VARIANTS,
    FusedInference,
)
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as tckpt
from test_torch_wide import numpy_int8_trunk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
orbax_to_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_torch)

MANIFEST = trained.manifest()
# the conversion, record and forward tests take the studies' networks too;
# the variant and int8 tests stay on NAMES
ALL_NAMES = trained.NAMES + trained.STUDY_NAMES
POSITIONS, PLIES, VARIANT_POSITIONS, TRUNK_BATCH = 256, 20, 64, 64
BLOCKS = 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op pool at one thread, as in ``test_torch_cli.py``:
    the test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def jax_checkpoint(name):
    """(variables, step, iteration, config) of the network's orbax source."""
    src = os.path.join(REPO, MANIFEST["networks"][name]["source"])
    return orbax_to_torch.load_jax_checkpoint(src)


@functools.cache
def player(name):
    return MCTSPlayer.from_checkpoint(trained.checkpoint(name), device="cpu")


@functools.cache
def positions():
    """(features (B, 8, 8, 3), legal (B, 65)) of POSITIONS boards after PLIES
    uniform random legal moves from ``default_rng(0)``."""
    eng = get_engine(8, "reference")
    rng = np.random.default_rng(0)
    boards = eng.initial_state((POSITIONS,), device="cpu")
    for _ in range(PLIES):
        legal = eng.legal_actions(boards).numpy()
        action = np.array([rng.choice(np.flatnonzero(row)) for row in legal])
        boards, _ = eng.step(boards, torch.from_numpy(action))
    return eng.features(boards), eng.legal_actions(boards).numpy()


@functools.cache
def bf16_forward(name):
    """The port's bf16 eval forward, as the port's player plays: numpy
    (log_probs, value)."""
    lp, v = player(name).net(positions()[0])
    return lp.numpy(), v.numpy()


def top_moves(log_probs, legal):
    return np.where(legal, log_probs, -np.inf).argmax(-1)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_committed_file_is_a_fresh_conversion(name):
    entry = MANIFEST["networks"][name]
    path = trained.checkpoint(name)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == entry["sha256"]
    assert os.path.getsize(path) == entry["bytes"]
    assert entry["command"].split()[-2:] == [entry["source"], os.path.relpath(path, REPO)]
    variables, step, iteration, cfg = jax_checkpoint(name)
    saved = tckpt.load(path)
    assert sorted(saved) == ["iteration", "model", "step"]
    assert (saved["step"], saved["iteration"]) == (step, iteration) \
        == (entry["step"], entry["iteration"])
    want = from_jax_variables(variables)
    assert saved["model"].keys() == want.keys()
    for k, t in want.items():
        assert saved["model"][k].dtype == t.dtype and torch.equal(saved["model"][k], t), k
    assert tckpt.load_config(path) == cfg
    assert os.path.basename(path) + ".config.json" == entry["config"]


def quoted(record):
    """The value a manifest record quotes, read from its file."""
    path = os.path.join(REPO, record["file"])
    if "line" in record:
        with open(path) as f:
            return f.read().splitlines()[record["line"] - 1]
    with open(path) as f:
        value = json.load(f)
    for part in record["key"].split("."):
        value = value[part]
    return value


@pytest.mark.parametrize("name", ALL_NAMES)
def test_manifest_quotes_the_jax_records(name):
    records = MANIFEST["networks"][name]["records"]
    assert records
    for r in records:
        got = quoted(r)
        if "line" in r:  # a row of a markdown table: "| Minimax d4 / exact 10 | 15W-1L-0D | ..."
            assert f"| {r['wins']}W-{r['losses']}L-{r['draws']}D |" in got
            assert got.startswith(f"| Minimax d{r['opponent'][-1]} ")
        elif "elo_vs_random" in r:
            assert (got["elo_vs_random"], got["ci95"]) == (r["elo_vs_random"], r["ci95"])
        elif "network_side" in r:  # an elo_ladder pair: wins_a / wins_b
            other = "b" if r["network_side"] == "a" else "a"
            assert (got[f"wins_{r['network_side']}"], got[f"wins_{other}"], got["draws"],
                    got["n"]) == (r["wins"], r["losses"], r["draws"], r["games"])
        else:  # a benchmark_ai row
            assert (got["wins"], got["losses"], got["draws"]) == (r["wins"], r["losses"],
                                                                  r["draws"])
            assert r["wins"] + r["losses"] + r["draws"] == r["games"]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_bf16_forward_matches_jax(name):
    variables = jax_checkpoint(name)[0]
    feats, legal = positions()
    model = jresnet.OthelloResNet(num_blocks=BLOCKS, num_filters=128, board_size=8)
    apply = jtrainer.apply_eval(model)
    args = (jax.tree.map(jnp.asarray, variables), jnp.asarray(feats.numpy()))
    # called as the JAX package's checkpoint tests call it, op by op: under
    # jit XLA's CPU compiler fuses the BatchNorm's multiply and add, which
    # moves a sharp trained policy as far as the port's own summation order
    lp_j, v_j = (np.asarray(a) for a in apply(*args))
    lp_t, v_t = bf16_forward(name)
    assert lp_t.shape == lp_j.shape == (POSITIONS, 65) and np.all(np.isfinite(lp_t))
    agree = (top_moves(lp_t, legal) == top_moves(lp_j, legal)).mean()
    lp_jit, v_jit = (np.asarray(a) for a in jax.jit(apply)(*args))
    print(f"{name}: port vs JAX apply_eval: agreement {agree:.4f}, probs "
          f"{np.abs(np.exp(lp_t) - np.exp(lp_j)).max():.4f}, value {np.abs(v_t - v_j).max():.4f}; "
          f"JAX jitted vs op by op: agreement "
          f"{(top_moves(lp_jit, legal) == top_moves(lp_j, legal)).mean():.4f}, probs "
          f"{np.abs(np.exp(lp_jit) - np.exp(lp_j)).max():.4f}, value "
          f"{np.abs(v_jit - v_j).max():.4f}")
    assert agree >= 0.98
    np.testing.assert_allclose(np.exp(lp_t), np.exp(lp_j), atol=0.03, rtol=0)
    np.testing.assert_allclose(v_t, v_j, atol=0.05, rtol=0)


@pytest.mark.parametrize("name", trained.NAMES)
@pytest.mark.parametrize("variant", PORTED_VARIANTS)
def test_variant_agrees_with_the_bf16_forward(variant, name):
    feats, legal = positions()
    x, legal = feats[:VARIANT_POSITIONS], legal[:VARIANT_POSITIONS]
    lp, v = FusedInference(player(name).model, variant=variant)(x)
    lp_ref, v_ref = (a[:VARIANT_POSITIONS] for a in bf16_forward(name))
    assert np.all(np.isfinite(lp.numpy())) and np.all(np.isfinite(v.numpy()))
    assert (top_moves(lp.numpy(), legal) == top_moves(lp_ref, legal)).mean() >= 0.9
    assert np.corrcoef(v.numpy()[:, 0], v_ref[:, 0])[0, 1] > 0.95


@pytest.mark.parametrize("record", ["elo_ladder", "symmetry_ablation"])
def test_shipped_record_copies_are_the_jax_records(record):
    with open(os.path.join(REPO, "results", f"{record}.json")) as f:
        want = json.load(f)
    got = trained.study_record(record)
    assert got["pairs"] == want["pairs"] and got == want


def test_every_shipped_network_has_a_ladder_name():
    names = [e["ladder_name"] for e in MANIFEST["networks"].values()]
    assert sorted(MANIFEST["networks"]) == sorted(ALL_NAMES) and len(set(names)) == len(names)


@functools.cache
def flagship_trunks():
    """The port's FusedInference(int8_dx3) on flagship r5, the JAX quantized
    trunk of the same weights, and the port's stem output at TRUNK_BATCH."""
    fused = FusedInference(player("flagship_r5").model, variant="int8_dx3")
    qt = jq.quantize_trunk(jax.tree.map(jnp.asarray, jax_checkpoint("flagship_r5")[0]), BLOCKS)
    return fused, qt, fused.stem(positions()[0][:TRUNK_BATCH])


@functools.cache
def numpy_reference(xla_rewrites):
    _, qt, h = flagship_trunks()
    return numpy_int8_trunk(h.float().numpy(), *(np.asarray(a) for a in qt), TRUNK_BATCH,
                            reciprocal=xla_rewrites, fused_dequant=xla_rewrites)


def test_jax_and_port_quantize_trained_weights_alike():
    fused, qt, _ = flagship_trunks()
    for jax_part, port_part in zip(qt, fused.qt):
        np.testing.assert_array_equal(np.asarray(jax_part), port_part.numpy())


@pytest.mark.parametrize("variant", ["int8_dx3", "int8_xla"])
def test_int8_departure_is_xlas_rewrites(variant):
    fused, qt, h = flagship_trunks()
    x = jnp.asarray(h.float().numpy())
    if variant == "int8_dx3":
        jax_out = fused_trunk_int8(x.astype(jnp.bfloat16), qt.w_int8, qt.w_scale, qt.bias,
                                   BLOCKS, block_games=TRUNK_BATCH, interpret=True,
                                   kernel="dx3")
        port = fused
    else:
        jax_out = jax.jit(lambda a: jq.xla_int8_trunk(a, qt, BLOCKS).astype(jnp.bfloat16))(x)
        port = FusedInference(player("flagship_r5").model, variant="int8_xla")
    jax_out = np.asarray(jax_out.astype(jnp.float32))
    port_out = port.trunk(h).float().numpy()
    assert np.all(np.isfinite(port_out))
    np.testing.assert_array_equal(jax_out.view(np.uint32), numpy_reference(True).view(np.uint32))
    np.testing.assert_array_equal(port_out.view(np.uint32),
                                  numpy_reference(False).view(np.uint32))
    # what the rewrites move end to end: the port's heads on each trunk
    legal = positions()[1][:TRUNK_BATCH]
    lp_j, v_j = port.heads(torch.from_numpy(jax_out).to(torch.bfloat16))
    lp_p, v_p = port.heads(torch.from_numpy(port_out).to(torch.bfloat16))
    agree = (top_moves(lp_j.numpy(), legal) == top_moves(lp_p.numpy(), legal)).mean()
    print(f"{variant}: JAX trunk values differing {(jax_out != port_out).mean():.4f}; "
          f"top move agreement through the port's heads {agree:.4f}; largest difference "
          f"probs {float((lp_j.exp() - lp_p.exp()).abs().max()):.4f}, "
          f"value {float((v_j - v_p).abs().max()):.4f}")
    assert agree >= 0.9
