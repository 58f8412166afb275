"""The port's user entry points against the JAX package: config loading,
the engine's text, the model helpers, profiling, the CLI, export and the
reference bridge.

Inputs are made from a numpy seed (or are the repository's own files) and
fed to both packages. Tolerances, each with its reason:

- the YAML reader, ``load_config``, ``_validate``'s errors, the unknown-key
  warnings, ``to_string``, ``model_flops_per_board`` and the parser:
  exact (the same text, values and messages);
- ``predict`` at float32: probs and value atol 1e-5 (the same network, one
  summation order per framework);
- ``export reference-pt``: bit-equal state dicts (both are copies of the
  same float32 weights; JAX's goes through the flax layout and back);
- TorchScript, port vs JAX, on one NCHW batch: atol 1e-5 (two float32
  networks with other summation orders);
- the ``torch.export`` program reloaded: atol 1e-5 against the network.

The whole-slice tests run the port's CLI alone (2 blocks x 16 filters, 2
simulations, ``--device cpu``); where a JSON artifact's keys are compared
with the JAX command's, the JAX match is stubbed, since its keys, not its
games, are the contract.
"""

import argparse
import contextlib
import glob
import io
import json
import os
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from othello_reinforcement_learning_test_tpu import cli as jcli
from othello_reinforcement_learning_test_tpu.models import resnet as jresnet
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.utils import config as jconfig
from othello_reinforcement_learning_test_tpu.utils import profiling as jprofiling
from othello_reinforcement_learning_test_tpu_torch import cli
from othello_reinforcement_learning_test_tpu_torch.models import export as texport
from othello_reinforcement_learning_test_tpu_torch.models import resnet as tresnet
from othello_reinforcement_learning_test_tpu_torch.models import torch_bridge as tbridge
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
    init_train_variables,
)
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board, get_engine
from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as ckpt
from othello_reinforcement_learning_test_tpu_torch.utils import config as tconfig
from othello_reinforcement_learning_test_tpu_torch.utils import profiling as tprofiling
from torch_stub_net import to_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
REF_PT = os.path.join(REPO, "results", "parity_models", "ref_seed7.pt")
TINY = {
    "game": {"size": 8},
    "model": {"num_blocks": 2, "num_filters": 16},
    "training": {"batch_size": 16, "lr": 0.01, "num_iterations": 2,
                 "self_play_episodes_per_iter": 3, "train_epochs_per_iter": 2,
                 "checkpoint_interval": 1, "replay_buffer_size": 2048},
    "mcts": {"num_simulations": 2},
    "self_play": {"temperature_threshold": 3},
    "system": {"device": "cpu", "seed": 3},
}


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


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """MetricsWriter writes TensorBoard files only when it imports; here
    that would pull in tensorflow (tens of seconds)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# -- config --------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_file_matches_pyyaml_and_jax(path):
    with open(path) as f:
        assert tconfig.read_yaml(path) == yaml.safe_load(f)
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        port = tconfig.load_config(path)
    with warnings.catch_warnings(record=True) as w_jax:
        warnings.simplefilter("always")
        ref = jconfig.load_config(path)
    assert port == ref
    assert [str(w.message) for w in w_port] == [str(w.message) for w in w_jax]
    assert tconfig.parse_yaml(tconfig.to_yaml(port)) == port


def test_load_config_without_a_path_is_the_defaults():
    assert tconfig.load_config() == jconfig.load_config() == jconfig.DEFAULTS
    assert tconfig.load_config() is not tconfig.DEFAULTS


def test_unknown_keys_warn_as_jax(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(
        "# unknown section, key and nested key; a section that is no mapping\n"
        "frobnicate:\n  a: 1\n"
        "game: 6\n"
        "model:\n  num_blocks: 2\n  width: 3\n"
        "training:\n  gating:\n    enabled: true\n    patience: 2\n  warmup: 5\n"
        "mcts:\n  num_simulations: 4   # trailing comment\n")
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        port = tconfig.load_config(str(path))
    with warnings.catch_warnings(record=True) as w_jax:
        warnings.simplefilter("always")
        ref = jconfig.load_config(str(path))
    assert port == ref
    assert [str(w.message) for w in w_port] == [str(w.message) for w in w_jax]
    assert len(w_port) == 5


VALIDATE_CASES = {
    **{f"training.{k}": ("training", k, 0) for k in (
        "batch_size", "num_iterations", "self_play_episodes_per_iter",
        "train_epochs_per_iter", "checkpoint_interval", "replay_buffer_size")},
    "lr": ("training", "lr", 0.0),
    "lr_schedule": ("training", "lr_schedule", "cosine"),
    "gating_not_mapping": ("training", "gating", "on"),
    "gating_games": ("training", "gating", {"enabled": True, "games": 0}),
    "gating_threshold": ("training", "gating", {"enabled": True, "win_threshold": 1.5}),
    "num_simulations": ("mcts", "num_simulations", 0),
    "dirichlet_epsilon": ("mcts", "dirichlet_epsilon", 1.5),
    "size": ("game", "size", 5),
    "rules": ("game", "rules", "house"),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_raises_as_jax(case):
    section, key, value = VALIDATE_CASES[case]
    errors = []
    for mod in (tconfig, jconfig):
        cfg = mod.load_config()
        cfg[section][key] = value
        with pytest.raises(Exception) as e:
            mod._validate(cfg)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] is ValueError


@pytest.mark.parametrize("text", [
    "a: [1, 2]", "a: {b: 1}", "a: |\n  x", "a: >\n  x", "a: &anchor 1", "a: *alias",
    "a: !!str 1", "a:\n\tb: 1", "- 1", "a:\n  - 1", "a: yes", "a: 0x1F", "a: 017",
    "a: 1_000", "a: 1:30", "a: .inf", "a: 2001-01-01", "a: 1\na: 2", "a: 'open",
    "a: b: c", "a:b", "a: 1\n   b: 2", "on: 1", "---\na: 1", "%YAML 1.2", "a: \"\\x41\"",
    "a: \"tab\\there\"", "'a': 1", "\"a\": 1",
], ids=repr)
def test_reader_refuses_what_it_does_not_take(text):
    with pytest.raises(tconfig.YAMLSubsetError):
        tconfig.parse_yaml(text)


def test_reader_scalars_and_nesting():
    text = ("# a comment\n"
            "s:\n"
            "  i: -3\n  f: 0.5\n  e: 1e-4\n  E: 2.5E+3\n  d: .25\n"
            "  t: true\n  F: False\n  n: null\n  z: ~\n  empty:\n"
            "  q: 'it''s # not a comment'\n  qq: \"no # comment\"\n  p: plain text # comment\n"
            "  deep:\n    k: v\n")
    assert tconfig.parse_yaml(text) == {"s": {
        "i": -3, "f": 0.5, "e": 1e-4, "E": 2500.0, "d": 0.25, "t": True, "F": False,
        "n": None, "z": None, "empty": None, "q": "it's # not a comment",
        "qq": "no # comment", "p": "plain text", "deep": {"k": "v"}}}
    # where pyyaml (YAML 1.1) and the reader agree, they agree exactly
    agreed = "\n".join(ln for ln in text.splitlines() if " e:" not in ln)
    assert tconfig.parse_yaml(agreed) == yaml.safe_load(agreed)
    assert tconfig.parse_yaml("") == {} and tconfig.parse_yaml("# only\n\n") == {}


# -- engine text and model helpers -----------------------------------------------


@pytest.mark.parametrize("rules", ["reference", "standard"])
@pytest.mark.parametrize("size", [4, 6, 8])
def test_to_string_matches_jax(size, rules):
    eng, jeng = get_engine(size, rules), jbb.get_engine(size, rules)
    rng = np.random.default_rng(size * 10 + (rules == "standard"))
    s = eng.initial_state((4,))
    for ply in range(size * size):
        for i in range(4 if ply % 3 == 0 else 0):
            b = Board(*(t[i] for t in s))
            jb = jbb.Board(me=jnp.asarray(to_pair(b.me.numpy())),
                           opp=jnp.asarray(to_pair(b.opp.numpy())),
                           move_count=jnp.asarray(b.move_count.numpy()),
                           passed=jnp.asarray(b.passed.numpy()))
            assert eng.to_string(b) == jeng.to_string(jb)
        legal = eng.legal_actions(s).numpy()
        action = torch.tensor([rng.choice(np.flatnonzero(row)) for row in legal])
        s, _ = eng.step(s, action)
    with pytest.raises(ValueError):
        eng.to_string(s)


def test_create_model_and_init_variables():
    cfg = {"model": {"num_blocks": 2, "num_filters": 16, "board_size": 6}}
    model = tresnet.create_model(cfg)
    jmodel = jresnet.create_model(cfg)
    assert (model.num_blocks, model.num_filters, model.board_size) == (
        jmodel.num_blocks, jmodel.num_filters, jmodel.board_size)
    assert tresnet.create_model(cfg["model"]).board_size == 6
    sd = tresnet.init_variables(model, 7)
    want = from_jax_variables(init_train_variables(2, 16, 7, 6))
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    model.load_state_dict(sd)
    a = tresnet.init_variables(model, torch.Generator().manual_seed(1))
    b = tresnet.init_variables(model, torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_predict_matches_jax():
    variables = init_numpy_variables(2, 16, seed=11)
    jmodel = jresnet.OthelloResNet(num_blocks=2, num_filters=16, dtype=jnp.float32)
    model = tresnet.create_model({"model": {"num_blocks": 2, "num_filters": 16}})
    sd = from_jax_variables(variables)
    x = (np.random.default_rng(5).random((6, 8, 8, 3)) < 0.4).astype(np.float32)
    for batch in (x, x[2]):  # batched and unbatched
        jp, jv = jresnet.predict(jmodel, variables, jnp.asarray(batch))
        p, v = tresnet.predict(model, sd, torch.from_numpy(batch), torch.float32)
        assert p.shape == jp.shape and v.shape == jv.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    model.load_state_dict(sd)
    p, _ = tresnet.predict(model, model.state_dict(), torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(p.numpy(), np.asarray(jresnet.predict(jmodel, variables, x)[0]),
                               rtol=0, atol=1e-5)


# -- profiling -----------------------------------------------------------------


@pytest.mark.parametrize("arch", [(10, 128, 8), (2, 16, 6), (4, 32, 4)])
def test_model_flops_per_board_matches_jax(arch):
    assert tprofiling.model_flops_per_board(*arch) == jprofiling.model_flops_per_board(*arch)


def test_profiling_on_the_cpu():
    timer = tprofiling.PhaseTimer()
    x = torch.ones(3)
    for _ in range(2):
        with timer.phase("a", fence=x):
            x = x + 1
    with timer.phase("b", fence=torch.device("cpu")):
        pass
    s = timer.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1 and "a " in timer.report()
    assert s["a"]["self_s"] == s["a"]["total_s"] > 0


# -- the parser ------------------------------------------------------------------


def _parser_table(parser: argparse.ArgumentParser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: sorted((tuple(a.option_strings), a.dest, repr(a.default), repr(a.choices),
                      repr(a.nargs), repr(a.const), a.required, type(a).__name__)
                     for a in p._actions)
        for name, p in sub.choices.items()}


def test_parser_equals_jax():
    port, ref = _parser_table(cli.build_parser()), _parser_table(jcli.build_parser())
    assert sorted(port) == sorted(ref) == ["eval", "export", "play", "train"]
    for name in ref:
        assert port[name] == ref[name], name
    top = [(tuple(a.option_strings), a.dest) for a in cli.build_parser()._actions]
    assert top == [(tuple(a.option_strings), a.dest) for a in jcli.build_parser()._actions]


# -- the whole slice, port only ----------------------------------------------------


def _write_tiny(path, iterations, tmp):
    cfg = json.loads(json.dumps(TINY))
    cfg["training"]["num_iterations"] = iterations
    cfg["paths"] = {"checkpoint_dir": str(tmp / "models"), "log_dir": str(tmp / "logs")}
    path.write_text(tconfig.to_yaml(cfg))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli train`` for 2 iterations, then ``--resume latest`` to 3: the
    two runs' output and the checkpoint directory."""
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    tmp = tmp_path_factory.mktemp("cli")
    path = tmp / "tiny.yaml"
    logs = []
    try:
        for iterations, extra in ((2, []), (3, ["--resume", "latest"])):
            _write_tiny(path, iterations, tmp)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["train", "--config", str(path), *extra])
            logs.append(out.getvalue())
    finally:
        mp.undo()
    return logs, tmp / "models"


def test_cli_train_and_resume(trained):
    (first, second), models = trained
    assert "iter 1/2" in first and "iter 2/2" in first
    assert "resumed from" in second and "at iteration 2" in second
    assert "iter 3/3" in second and "iter 1/" not in second and "iter 2/" not in second
    names = sorted(os.listdir(models))
    for n in ("checkpoint_iter_000001.pt", "checkpoint_iter_000003.pt", "final_model.pt"):
        assert n in names
    assert ckpt.load_train_state(str(models / "final_model.pt"))["iteration"] == 3


@pytest.mark.parametrize("how", ["--coordinator", "--num-processes", "--process-id", "env"])
def test_cli_train_refuses_multi_process(how, tmp_path, monkeypatch, capsys):
    """As the JAX CLI: a coordinator (flag or ``$OTHELLO_COORDINATOR``)
    without the process count and id exits with its message before any
    training; ``--num-processes`` or ``--process-id`` without a coordinator
    is ignored, and the run trains in one process. A 2-process run through
    the CLI is in ``test_torch_parallel.py``."""
    path = tmp_path / "tiny.yaml"
    _write_tiny(path, 1, tmp_path)
    argv = ["train", "--config", str(path)]
    for name in ("OTHELLO_COORDINATOR", "OTHELLO_NUM_PROCESSES", "OTHELLO_PROCESS_ID",
                 "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    if how == "env":
        monkeypatch.setenv("OTHELLO_COORDINATOR", "localhost:1234")
    else:
        argv += [how, "localhost:1" if how == "--coordinator" else "2"]
    if how in ("--coordinator", "env"):
        with pytest.raises(SystemExit, match="--coordinator requires --num-processes and "
                                             "--process-id"):
            cli.main(argv)
        assert not (tmp_path / "models").exists()
        return
    cli.main(argv)
    out = capsys.readouterr().out
    assert "iter 1/1" in out and "distributed:" not in out
    assert (tmp_path / "models" / "final_model.pt").is_file()


def test_cli_eval_saves_the_jax_keys(trained, tmp_path, monkeypatch, capsys):
    from othello_reinforcement_learning_test_tpu import evaluation as jevaluation

    _, models = trained
    monkeypatch.chdir(tmp_path)
    cli.main(["eval", "--checkpoint", str(models / "final_model.pt"), "--games", "2",
              "--simulations", "2", "--device", "cpu", "--save-results"])
    port_files = glob.glob(str(tmp_path / "data" / "eval" / "eval_*.json"))
    assert len(port_files) == 1
    port = json.load(open(port_files[0]))
    os.remove(port_files[0])

    # the JAX command, its player and matches stubbed
    def fake_player(path, num_simulations=50):
        return argparse.Namespace(engine=jbb.get_engine(8, "reference"))

    def fake(player, opponent, engine, num_games=20, **kw):
        return {"opponent": opponent.name, "num_games": num_games, "wins": 1, "losses": 1,
                "draws": 0, "win_rate": 0.5, "avg_score": 32.0, "avg_moves": 60.0,
                "results": []}

    monkeypatch.setattr(jevaluation, "evaluate_player", fake)
    monkeypatch.setattr(jevaluation.MCTSPlayer, "from_checkpoint", fake_player)
    jcli.main(["eval", "--checkpoint", REF_PT, "--games", "2", "--simulations", "2",
               "--device", "cpu", "--save-results"])
    (ref_file,) = glob.glob(str(tmp_path / "data" / "eval" / "eval_*.json"))
    ref = json.load(open(ref_file))
    assert sorted(port) == sorted(ref)
    assert sorted(port["results"]) == sorted(ref["results"]) == ["Greedy", "Random"]
    for name in ref["results"]:
        assert sorted(port["results"][name]) == sorted(ref["results"][name])
    assert port["games_per_opponent"] == 2 and port["mcts_simulations"] == 2
    r = port["results"]["Random"]
    assert r["wins"] + r["losses"] + r["draws"] == 2


def test_cli_eval_records_a_failing_opponent(trained, monkeypatch, capsys):
    from othello_reinforcement_learning_test_tpu_torch import evaluation

    _, models = trained
    real = evaluation.evaluate_player

    def flaky(player, opponent, *a, **kw):
        if opponent.name == "Greedy":
            raise RuntimeError("opponent crashed")
        return real(player, opponent, *a, **kw)

    monkeypatch.setattr(evaluation, "evaluate_player", flaky)
    cli.main(["eval", "--checkpoint", str(models / "final_model.pt"), "--games", "2",
              "--simulations", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "vs Random" in out and "vs Greedy: evaluation failed (opponent crashed)" in out


def test_cli_play_to_game_over(trained, monkeypatch, capsys):
    _, models = trained

    def first_legal(prompt):
        return prompt[prompt.index("[") + 1:].split("]")[0].split(",")[0]

    monkeypatch.setattr(cli, "input", first_legal, raising=False)
    cli.main(["play", "--checkpoint", str(models / "final_model.pt"), "--simulations", "2",
              "--device", "cpu", "--color", "white"])
    out = capsys.readouterr().out
    assert "you are white" in out and "AI plays" in out and "game over:" in out


def test_cli_eval_and_play_need_cuda_unless_cpu(trained):
    if torch.cuda.is_available():
        pytest.skip("a card is present: auto runs on it")
    _, models = trained
    for command in ("eval", "play"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([command, "--checkpoint", str(models / "final_model.pt")])


# -- export and the reference bridge ------------------------------------------------


def test_export_reference_pt_bit_equal_to_jax(tmp_path):
    port_out, jax_out = tmp_path / "port.pt", tmp_path / "jax.pt"
    cli.main(["export", "--checkpoint", REF_PT, "--out", str(port_out)])
    jcli.main(["export", "--checkpoint", REF_PT, "--out", str(jax_out)])
    port = torch.load(port_out, weights_only=True)
    ref = torch.load(jax_out, weights_only=True)
    assert sorted(port) == sorted(ref)
    assert port["model_state_dict"].keys() == ref["model_state_dict"].keys()
    for k, t in ref["model_state_dict"].items():
        assert port["model_state_dict"][k].dtype == t.dtype
        assert torch.equal(port["model_state_dict"][k], t), k
    assert port["optimizer_state_dict"] == ref["optimizer_state_dict"]
    assert port["scheduler_state_dict"] == ref["scheduler_state_dict"]
    assert (port["global_step"], port["epoch"], port["config"]) == (
        ref["global_step"], ref["epoch"], ref["config"])
    # and it loads back as the same network
    model, sd, cfg = tbridge.load_reference_checkpoint(str(port_out))
    assert tbridge.infer_architecture(sd) == (4, 32, 8, 256) and cfg == ref["config"]


def test_torchscript_matches_jax(tmp_path):
    port_out, jax_out = tmp_path / "port.ts", tmp_path / "jax.ts"
    cli.main(["export", "--checkpoint", REF_PT, "--out", str(port_out), "--format",
              "torchscript", "--batch-size", "4"])
    jcli.main(["export", "--checkpoint", REF_PT, "--out", str(jax_out), "--format",
               "torchscript", "--batch-size", "4"])
    x = torch.from_numpy((np.random.default_rng(3).random((4, 3, 8, 8)) < 0.4)
                         .astype(np.float32))
    with torch.no_grad():
        lp, v = torch.jit.load(str(port_out))(x)
        jlp, jv = torch.jit.load(str(jax_out))(x)
    torch.testing.assert_close(lp, jlp, rtol=0, atol=1e-5)
    torch.testing.assert_close(v, jv, rtol=0, atol=1e-5)


def test_torch_export_reloads_equal_to_the_network(tmp_path):
    out = tmp_path / "net.pt2"
    cli.main(["export", "--checkpoint", REF_PT, "--out", str(out), "--format", "stablehlo",
              "--batch-size", "4"])
    assert (tmp_path / "net.pt2.txt").read_text()
    model, _, _ = tbridge.load_reference_checkpoint(REF_PT)
    x = torch.from_numpy((np.random.default_rng(4).random((4, 8, 8, 3)) < 0.4)
                         .astype(np.float32))
    lp, v = texport.load_exported(str(out), "cpu")(x)
    with torch.no_grad():
        want_lp, want_v = model(x, train=False, compute_dtype=torch.float32)
    torch.testing.assert_close(lp, want_lp, rtol=0, atol=1e-5)
    torch.testing.assert_close(v, want_v, rtol=0, atol=1e-5)


def test_onnx_raises_as_jax(tmp_path):
    errors = []
    for main in (cli.main, jcli.main):
        with pytest.raises(Exception) as e:
            main(["export", "--checkpoint", REF_PT, "--out", str(tmp_path / "m.onnx"),
                  "--format", "onnx"])
        errors.append((type(e.value), str(e.value).split(":")[0]))
    assert errors[0] == errors[1] == (RuntimeError, "torch ONNX export unavailable")


def test_bridge_round_trip_and_infer_architecture():
    sd = from_jax_variables(init_numpy_variables(3, 8, seed=2, board_size=6, value_hidden=32))
    ref = tbridge.to_reference_state_dict(sd)
    assert list(ref) == list(tresnet.OthelloResNet(3, 8, 6, 32).state_dict())
    assert tbridge.infer_architecture(ref) == (3, 8, 6, 32)
    model, back = tbridge.from_reference_state_dict(ref)
    assert (model.num_blocks, model.num_filters, model.board_size, model.value_hidden) == (
        3, 8, 6, 32)
    assert all(torch.equal(back[k], ref[k]) for k in ref)
    assert all(torch.equal(model.state_dict()[k], ref[k]) for k in ref)
