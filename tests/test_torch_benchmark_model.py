"""The port's network benchmark
(``othello_reinforcement_learning_test_tpu_torch/benchmark_model.py``) on the
CPU at a tiny size: one row per (table, batch) for the unfused forward at
bf16 and f32 and for every ported fused variant, the flags and defaults of
the JAX package's ``benchmark_model.py``, and the refusal of a name that
is no variant. Numbers from a CPU run are not device metrics; only the
rows are checked here.
"""

import argparse

import pytest

import benchmark_model as jax_benchmark_model
from othello_reinforcement_learning_test_tpu_torch import benchmark_model
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import PORTED_VARIANTS

TINY = ["--device", "cpu", "--blocks", "1", "--filters", "16", "--batches", "1", "8",
        "--repeats", "1", "--chain", "2"]


def test_every_ported_variant_gives_a_row_per_batch(capsys):
    out = benchmark_model.run(TINY + ["--fused", "--fused-variants", *PORTED_VARIANTS])
    tables = ["bf16", "f32", *PORTED_VARIANTS]
    assert [(r["table"], r["batch"]) for r in out["rows"]] == [
        (t, b) for t in tables for b in (1, 8)]
    assert all(r["status"] in ("ok", "dispatch-dominated") for r in out["rows"])
    assert out["device"] == "cpu" and out["params"] > 0 and "memory_mib" not in out
    printed = capsys.readouterr().out
    for variant in PORTED_VARIANTS:
        assert f"--- fused trunk variant {variant} (eval mode, block_games=" in printed
    assert "per-call dispatch overhead" in printed and "--- compute dtype f32 ---" in printed


class _Defaults(Exception):
    pass


def test_flag_defaults_match_benchmark_model_py(monkeypatch):
    """The JAX script builds its parser inside ``main``: catch the namespace
    it parses from no arguments, before it imports JAX."""
    parse = argparse.ArgumentParser.parse_args

    def defaults(self, args=None, namespace=None):
        raise _Defaults(parse(self, []))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", defaults)
    with pytest.raises(_Defaults) as caught:
        jax_benchmark_model.main()
    monkeypatch.undo()
    want = vars(caught.value.args[0])
    got = vars(benchmark_model.parse_args([]))
    assert want.pop("platform") is None and got.pop("device") is None
    assert got == want


def test_unported_variant_names_roadmap(capsys):
    """``int8_dxcat``, the last variant to be ported, gives a row per batch;
    a name that is no variant is refused before anything runs."""
    out = benchmark_model.run(TINY + ["--fused", "--fused-variants", "int8_dxcat"])
    assert [(r["table"], r["batch"]) for r in out["rows"] if r["table"] == "int8_dxcat"] == [
        ("int8_dxcat", 1), ("int8_dxcat", 8)]
    assert "--- fused trunk variant int8_dxcat (eval mode, block_games=64" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown fused variant"):
        benchmark_model.run(TINY + ["--fused", "--fused-variants", "matmul9", "int8_dx4"])
