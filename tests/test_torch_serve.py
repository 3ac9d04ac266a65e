"""The port's serving layer (boa_tpu_torch/serve/{stream,warmup}.py) against
the reference's (boa_tpu/serve/), on the CPU, on volumes made from a seed
with numpy.

Bars: the same studies counted and the same label files written
(byte-identical) by both StreamRunners, a corrupt or failing study failing
its own job alone; the warm-up's z enumeration and the bake's task calls
equal to the reference's; the stamp and the missing-weights skip as
tests/test_warmup_bake.py has them.
"""

import logging

import numpy as np
import pytest
import torch

from boa_tpu.io import nifti as jn
from boa_tpu.serve import stream as jstream
from boa_tpu.serve import warmup as jwarm
from boa_tpu.tasks.registry import resolve_task as jresolve
from boa_tpu.weights.store import ModelStore as JStore
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.serve import stream as tstream
from boa_tpu_torch.serve import warmup as twarm
from boa_tpu_torch.tasks.registry import resolve_task as tresolve
from boa_tpu_torch.weights.store import ModelStore as TStore
from boa_tpu_torch.weights.store import create_synthetic_model


@pytest.fixture(autouse=True)
def _config_dir(tmp_path, monkeypatch):
    """Each test's own config; torch on two threads (the suite's workers
    share the cores)."""
    monkeypatch.setenv("BOA_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _fake(vol, spacing, task_id):
    """tests/test_sharded_stream.py's hook."""
    seg = np.zeros(vol.shape, np.uint8)
    seg[4:12, 4:12, 2:8] = 1
    return seg


def _jobs(pkg, root, tmp_path):
    """test_stream_runner's five studies, the third read from a file, plus
    one truncated file."""
    nifti = tn if pkg == "t" else jn
    mod = tstream if pkg == "t" else jstream
    jobs = []
    for k in range(5):
        data = np.full((24, 24, 12), -1000, np.int16)
        data[6:18, 6:18, :] = 40 + k
        img = nifti.NiftiImage(data=data, affine=np.diag([-1.5, -1.5, 3.0, 1.0]))
        if k == 2:
            nifti.save(img, tmp_path / f"{pkg}_s2.nii.gz")
            jobs.append(mod.StudyJob(study_id="s2", input_path=tmp_path / f"{pkg}_s2.nii.gz",
                                     output_dir=root / "out2"))
        else:
            jobs.append(mod.StudyJob(study_id=f"s{k}", image=img, output_dir=root / f"out{k}"))
    full = (tmp_path / f"{pkg}_s2.nii.gz").read_bytes()
    (tmp_path / f"{pkg}_bad.nii.gz").write_bytes(full[:len(full) // 2])
    jobs.insert(3, mod.StudyJob(study_id="bad", input_path=tmp_path / f"{pkg}_bad.nii.gz",
                                output_dir=root / "bad"))
    return jobs


def test_stream_runner_matches_reference(tmp_path, caplog):
    """test_stream_runner's inputs plus a truncated file: five studies
    predicted and written in both packages, the corrupt one failing alone,
    every label file the reference's bytes."""
    caplog.set_level(logging.ERROR)
    got = tstream.StreamRunner(task="total", fast=True, fake_predict=_fake, device="cpu",
                               store=TStore(tmp_path / "w")).run(
        _jobs("t", tmp_path / "t", tmp_path))
    want = jstream.StreamRunner(task="total", fast=True, fake_predict=_fake,
                                store=JStore(tmp_path / "w")).run(
        _jobs("j", tmp_path / "j", tmp_path))
    assert got.n_studies == want.n_studies == 5
    assert len(got.per_study_s) == 5 and got.volumes_per_min > 0
    assert any("study bad failed to decode" in r.getMessage() for r in caplog.records)
    for k in range(5):
        t = (tmp_path / "t" / f"out{k}" / "total.nii.gz").read_bytes()
        assert t == (tmp_path / "j" / f"out{k}" / "total.nii.gz").read_bytes(), k
    assert not (tmp_path / "t" / "bad").exists()


def test_stream_failing_predict_fails_its_job(tmp_path):
    """A study whose predict raises is skipped and the stream goes on, in
    both packages."""
    def flaky(vol, spacing, task_id):
        if vol.shape[2] == 5:
            raise RuntimeError("bad study")
        return np.zeros(vol.shape, np.uint8)

    counts = []
    for mod, nifti, store in ((tstream, tn, TStore), (jstream, jn, JStore)):
        jobs = [mod.StudyJob(study_id=f"s{z}", image=nifti.NiftiImage(
            data=np.full((16, 16, z), -1000, np.int16), affine=np.diag([-1.5, -1.5, 3.0, 1.0])))
            for z in (8, 5, 9)]
        kw = {"device": "cpu"} if mod is tstream else {}
        runner = mod.StreamRunner(task="total", fast=True, fake_predict=flaky,
                                  write_outputs=False, store=store(tmp_path / "w"), **kw)
        counts.append(runner.run(jobs).n_studies)
    assert counts == [2, 2]


def test_stream_num_parts_matches_reference(tmp_path):
    """files[part_id::num_parts], as test_stream_num_parts has it."""
    def zeros(vol, spacing, task_id):
        return np.zeros(vol.shape, np.uint8)

    for part in range(3):
        counts = []
        for mod, nifti, store in ((tstream, tn, TStore), (jstream, jn, JStore)):
            jobs = [mod.StudyJob(study_id=f"s{k}", image=nifti.NiftiImage(
                data=np.full((16, 16, 8), -1000, np.int16),
                affine=np.diag([-1.5, -1.5, 3.0, 1.0]))) for k in range(7)]
            kw = {"device": "cpu"} if mod is tstream else {}
            runner = mod.StreamRunner(task="total", fast=True, fake_predict=zeros,
                                      write_outputs=False, store=store(tmp_path / "w"), **kw)
            counts.append(runner.run(jobs, num_parts=3, part_id=part).n_studies)
        assert counts[0] == counts[1] == (3, 2, 2)[part]


def test_stream_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstream.StreamRunner(store=TStore(tmp_path / "w"))


@pytest.mark.parametrize("task,fast,spacing,z_range,bucket", [
    ("total", True, (1.5, 1.5, 3.0), (200, 600), 64),
    ("total", False, (0.8, 0.8, 1.25), (100, 400), 64),
    ("body_parts", False, (1.5, 1.5, 2.0), (50, 300), 32),
    ("liver_vessels", False, (0.7, 0.7, 0.5), (10, 200), 16),
])
def test_raw_z_for_buckets_matches_reference(task, fast, spacing, z_range, bucket):
    got = twarm._raw_z_for_buckets(tresolve(task, fast=fast), spacing, z_range, bucket)
    assert got == jwarm._raw_z_for_buckets(jresolve(task, fast=fast), spacing, z_range, bucket)
    if task == "total" and fast:   # tests/test_warmup_bake.py's count
        assert len(got) == 7


def test_full_bake_calls_match_reference(tmp_path, monkeypatch):
    """--full's task and in-plane set, call for call."""
    calls = {"t": [], "j": []}
    for key, mod, store in (("t", twarm, TStore), ("j", jwarm, JStore)):
        def record(store, name, *, fast, xy, _key=key, **kw):
            calls[_key].append((name, fast, xy))
            return [0.0]

        monkeypatch.setattr(mod, "warmup_task", record)
        mod.bake(store(tmp_path / "w"), full=True)
        mod.bake(store(tmp_path / "w"))
    assert calls["t"] == calls["j"] and ("total", False, (384, 320)) in calls["t"]


def test_bake_stamp_skips_and_tolerates_missing_weights(tmp_path, caplog):
    """tests/test_warmup_bake.py's case on the port: missing weights are a
    warning and the stamp lands; a second bake does no work."""
    store = TStore(tmp_path / "empty")
    stamp = tmp_path / "warm.stamp"
    with caplog.at_level(logging.WARNING, logger="boa_tpu_torch.serve.warmup"):
        twarm.bake(store, tasks=[("total", True)], stamp=str(stamp), device="cpu")
    assert stamp.exists()
    assert any("skipping bake of total" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="boa_tpu_torch.serve.warmup"):
        twarm.bake(store, tasks=[("total", True)], stamp=str(stamp), device="cpu")
    assert any("skipping bake" in r.message for r in caplog.records)
    assert not any("skipping bake of" in r.message for r in caplog.records)


def test_warmup_buckets_on_a_model(tmp_path, capsys):
    """test_warmup_buckets on the port (a tiny synthetic total_fast model):
    one study per bucketed extent, through the command too."""
    create_synthetic_model(tmp_path, 297, "TotalFast", num_classes=3,
                           trainer="nnUNetTrainer_4000epochs_NoMirroring",
                           patch_size=(16, 16, 16), features=(4, 8), n_folds=1)
    times = twarm.warmup_task(TStore(tmp_path), "total", fast=True, xy=24, z_range=(20, 40),
                              bucket=16, spacing=(3.0, 3.0, 3.0), device="cpu")
    assert len(times) == 2
    twarm.main(["--task", "total", "--fast", "--xy", "24", "--z-range", "20", "40",
                "--bucket", "16", "--spacing", "3", "3", "3", "--weights", str(tmp_path),
                "-d", "cpu"])
    assert "warmed 2 bucketed shapes" in capsys.readouterr().out
