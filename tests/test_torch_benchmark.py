"""The port's training benchmark (`boa_tpu_torch/engine/benchmark.py`)
against the reference's `boa_tpu/engine/benchmark.py` on the CPU: the
reference test's case (16^3, batch 1, two epochs of two steps), the keys of
benchmark_result.json (the reference's, with the torch version in place of
its JAX version and backend), `summarize_benchmark_results`, `main`'s
arguments as they reach `benchmark_training`, and the device rule."""

import json

import pytest
import torch

from boa_tpu.engine import benchmark as rb
from boa_tpu_torch.engine import benchmark as pb

SMALL = dict(patch=(16, 16, 16), batch_size=1, num_classes=3, features=(4, 8), n_epochs=2,
             iters_per_epoch=2)


def test_benchmark_training_small_case(tmp_path):
    res = pb.benchmark_training(tmp_path / "mine", device="cpu", **SMALL)
    assert res["it_per_s"] > 0
    blob = json.loads((tmp_path / "mine" / "benchmark_result.json").read_text())
    assert blob == res
    assert blob["device"] == "cpu" and blob["torch_version"] == torch.__version__
    assert len(blob["epoch_times_s"]) == 2
    assert blob["fastest_epoch_s"] == min(blob["epoch_times_s"])
    assert blob["it_per_s"] == pytest.approx(2 / blob["fastest_epoch_s"])


def test_result_keys_match_reference(tmp_path):
    mine = pb.benchmark_training(tmp_path / "mine", device="cpu", **SMALL)
    ref = rb.benchmark_training(tmp_path / "ref", **SMALL)
    assert set(mine) == (set(ref) - {"jax_version", "backend"}) | {"torch_version"}
    for k in ("patch_size", "batch_size", "iters_per_epoch"):
        assert mine[k] == ref[k]
    assert len(mine["epoch_times_s"]) == len(ref["epoch_times_s"])


def test_summarize_matches_reference(tmp_path):
    pb.benchmark_training(tmp_path / "a", device="cpu", **SMALL)
    rb.benchmark_training(tmp_path / "b", **SMALL)
    (tmp_path / "c").mkdir()
    folders = [tmp_path / "a", str(tmp_path / "b"), tmp_path / "c", tmp_path / "missing"]
    got = pb.summarize_benchmark_results(folders)
    assert got == rb.summarize_benchmark_results(folders)
    assert sorted(got) == [str(tmp_path / "a"), str(tmp_path / "b")]
    assert got[str(tmp_path / "a")]["device"] == "cpu"


def _captured(module, monkeypatch, argv):
    seen = {}

    def fake(out, **kw):
        seen.update(kw, out=out)
        return {k: 0 for k in ("backend", "device", "torch_version", "patch_size",
                               "batch_size", "iters_per_epoch", "fastest_epoch_s",
                               "it_per_s")}
    monkeypatch.setattr(module, "benchmark_training", fake)
    module.main(argv)
    return seen


@pytest.mark.parametrize("extra", [[], ["--flagship"], ["--epochs", "1"],
                                   ["--flagship", "--iters", "3", "--epochs", "2"]])
def test_main_arguments_match_reference(extra, monkeypatch, tmp_path, capsys):
    """`main` passes `benchmark_training` what the reference's passes, plus
    the device; it prints one JSON line and where the file went."""
    argv = ["-o", str(tmp_path)] + extra
    ref = _captured(rb, monkeypatch, argv)
    capsys.readouterr()
    mine = _captured(pb, monkeypatch, argv + ["-d", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert mine.pop("device") == "cpu"
    assert mine == ref
    assert set(json.loads(out[0])) == {"torch_version", "device", "patch_size", "batch_size",
                                       "iters_per_epoch", "fastest_epoch_s", "it_per_s"}
    assert out[1] == f"result written to {tmp_path}/benchmark_result.json"


def test_main_runs_on_the_host(tmp_path, capsys):
    pb.main(["-o", str(tmp_path), "--epochs", "1", "--iters", "1", "-d", "cpu"])
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["device"] == "cpu" and line["iters_per_epoch"] == 1
    assert json.loads((tmp_path / "benchmark_result.json").read_text())["patch_size"] == \
        [64, 64, 64]


def test_benchmark_needs_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.benchmark_training(tmp_path, **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.main(["-o", str(tmp_path), "--epochs", "1", "--iters", "1"])
