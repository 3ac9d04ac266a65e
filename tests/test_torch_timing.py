"""The port's spans on the profiler's clock (boa_tpu_torch/utils/timing.py):
nothing recorded and nothing waited on with no profiler, the study's layer
spans, their `boa.*` ranges in the profiler's events and their counters
under one, the `spans` dict unchanged by profiling, and the benchmark's five
readers of the recorded capture (perfbench/metrics/), CPU only."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from boa_tpu_torch import python_api as tapi
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.utils import timing
from boa_tpu_torch.utils.timing import Count, Span, Spans, Trace
from boa_tpu_torch.weights.store import ModelStore, create_synthetic_model

REPO = Path(__file__).resolve().parents[1]
PARTS = {291: "part1_organs", 292: "part2_vertebrae", 293: "part3_cardiac",
         294: "part4_muscles", 295: "part5_ribs"}
SHAPE = (40, 36, 32)
LAYERS = ["load_input", "body_crop", "upload+orient", "resample"] + [
    n for t in PARTS for n in ("load_weights", f"predict_{t}", "window", "merge")] + [
    "download+postprocess", "back_resample+pad", "save_nifti"]


@pytest.fixture()
def fresh(monkeypatch):
    """The recorder as at the process's start."""
    monkeypatch.setattr(timing, "_capture", None)
    monkeypatch.setattr(timing, "_taking", False)


def _raise(*a, **k):
    raise AssertionError("called with no profiler recording")


def _fake(vol, spacing, task_id):
    return np.zeros(vol.shape, np.uint8)


_fake.run_real = True   # the real predictor runs first; its labels are dropped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One small `total` study through `totalsegmentator(..., ml=True)` on
    five synthetic 1.5 mm sub-models, with a `spans` dict: once under the
    profiler (its events, the recorder's capture) and once without."""
    root = tmp_path_factory.mktemp("timing")
    for tid, name in PARTS.items():
        create_synthetic_model(root / "store", tid, name, num_classes=28,
                               trainer="nnUNetTrainerNoMirroring",
                               patch_size=(16, 16, 16), spacing=(1.5,) * 3,
                               features=(4, 8))
    data = np.full(SHAPE, -1000, np.int16)
    data[8:32, 8:28, :] = 40
    tn.save(tn.NiftiImage(data=data, affine=np.diag([-1.5, -1.5, 3.0, 1.0])),
            root / "ct.nii")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BOA_TPU_CONFIG_DIR", str(root / "cfg"))
        mp.setattr(timing, "_capture", None)
        mp.setattr(timing, "_taking", False)

        def one(tag, profiled):
            spans: dict = {}
            kw = dict(ml=True, task="total", quiet=True, store=ModelStore(root / "store"),
                      device="cpu", fake_predict=_fake, spans=spans)
            if not profiled:
                tapi.totalsegmentator(root / "ct.nii", root / tag / "total.nii.gz", **kw)
                return spans, None
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                tapi.totalsegmentator(root / "ct.nii", root / tag / "total.nii.gz", **kw)
            return spans, [ev.name() for ev in prof.profiler.kineto_results.events()]

        out["plain"], _ = one("plain", False)
        out["profiled"], out["events"] = one("profiled", True)
        out["trace"] = timing.last_trace()
        out["file"] = root / "profiled" / "total.nii.gz"
    return out


def test_off_records_nothing_and_never_waits(fresh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    sp = Spans(None, "cuda")
    for ctx in (sp.span("window"), timing.span("merge", "cuda"), timing.study()):
        assert ctx is timing._OFF   # the shared do-nothing context: no allocation
        with ctx:
            pass
    sp.add("tile_forwards", 3)
    timing.count("save_bytes", 10)
    assert timing.last_trace() is None


def test_out_dict_span_times_like_a_mark(fresh):
    out: dict = {}
    sp = Spans(out, "cpu")
    with sp.span("a"):
        pass
    with sp.span("a"):
        pass
    t = sp.t
    sp.mark("b")
    assert set(out) == {"a", "b"} and out["a"] >= 0 and sp.t >= t
    with pytest.raises(ValueError):
        with sp.span("c"):
            raise ValueError   # a stage that raised adds nothing, as a mark never reached
    assert "c" not in out and timing.last_trace() is None


def test_study_records_layers_with_parents(runs):
    tr = runs["trace"]
    assert tr.dropped == 0 and tr.studies() == 1
    names = [s.name for s in tr.spans]
    assert names == ["study"] + LAYERS
    study = tr.spans[0]
    assert study.parent is None and all(s.study == study.study for s in tr.spans)
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in tr.spans)
    assert all(s.device_ms is None for s in tr.spans)   # the CPU has no events
    part = None
    for i, s in enumerate(tr.spans[1:], 1):
        if s.name.startswith("predict_"):
            part = i
        # window and merge inside their part's span; load_weights its sibling
        assert s.parent == (part if s.name in ("window", "merge") else 0), s.name


def test_profiler_events_hold_the_layer_ranges(runs):
    boa = [n for n in runs["events"] if n.startswith("boa.")]
    assert sorted(set(boa)) == sorted({"boa." + n for n in LAYERS})
    assert len(boa) == len(LAYERS) and "boa.study" not in boa


def test_spans_dict_unchanged_by_profiling(runs):
    plain, prof = runs["plain"], runs["profiled"]
    assert set(plain) == set(prof)
    assert {"body_crop", "upload+orient", "resample", "load_weights", "save_nifti",
            "download+postprocess", "back_resample+pad"} | {
        f"predict_{t}" for t in PARTS} <= set(plain)
    assert not {"study", "load_input", "window", "merge"} & set(plain)
    for k in ("tiles", "tile_forwards"):
        assert plain[k] == prof[k]
    tr = runs["trace"]
    assert tr.total("tiles") == prof["tiles"] and tr.total("tile_forwards") == prof[
        "tile_forwards"] > 0


def test_save_counters(runs):
    tr = runs["trace"]
    assert tr.total("save_bytes") == int(np.prod(SHAPE))   # uint8 labels, padded back
    assert tr.total("save_gz_bytes") == os.path.getsize(runs["file"])
    save = [i for i, s in enumerate(tr.spans) if s.name == "save_nifti"]
    assert [c.span for c in tr.counts if c.name.startswith("save_")] == save * 2


def test_capture_bound_and_next_capture(fresh, monkeypatch):
    monkeypatch.setattr(timing, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.study():
            for _ in range(3):
                with timing.span("x"):
                    timing.count("n", 1)
    tr = timing.last_trace()
    assert [s.name for s in tr.spans] == ["study", "x"] and tr.total("n") == 1
    assert tr.dropped == 4 and tr.spans[1].parent == 0
    with timing.study():   # a study with no profiler ends the capture's intake
        pass
    assert timing.last_trace() == tr
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("y"):
            pass
    tr2 = timing.last_trace()
    assert [s.name for s in tr2.spans] == ["y"] and tr2.spans[0].study is None


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), REPO / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _capture() -> Trace:
    """Two studies: load 0.05 s and 0.07 s, save 4 s of 80 MB in all, two
    windows of 3 s host / 2 s device over 360 tile forwards, merges of 5 ms
    and 7 ms on the device."""
    ms = 1_000_000
    spans, counts = [], []
    for k, (load, merge) in enumerate(((50, 5.0), (70, 7.0))):
        root = len(spans)
        spans += [Span("study", k + 1, None, 0, 9000 * ms, None),
                  Span("load_input", k + 1, root, 0, load * ms, None),
                  Span("predict_291", k + 1, root, 0, 3100 * ms, 3050.0),
                  Span("window", k + 1, root + 2, 0, 1500 * ms, 1000.0),
                  Span("merge", k + 1, root + 2, 0, 10 * ms, merge),
                  Span("save_nifti", k + 1, root, 0, 2000 * ms, None)]
        counts += [Count("tile_forwards", 180, k + 1, root + 2),
                   Count("save_bytes", 40e6, k + 1, root + 5)]
    return Trace(tuple(spans), tuple(counts), 0)


@pytest.mark.parametrize("name,want", [
    ("api.input_ms", 60.0), ("api.save_mb_s", 20.0),
    ("window.dispatch_ms", 1e3 * 3.0 / 360), ("window.device_ms", 1e3 * 2.0 / 360),
    ("pipeline.merge_ms", 6.0)])
def test_readers_of_a_capture(name, want, monkeypatch):
    monkeypatch.setattr(timing, "last_trace", _capture)
    assert _reader(name)({}) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["api.input_ms", "api.save_mb_s", "window.dispatch_ms",
                                  "window.device_ms", "pipeline.merge_ms"])
def test_readers_without_a_capture(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(timing, "last_trace", lambda: None)
    assert read({}) is None
    host_only = _capture()._replace(spans=tuple(s._replace(device_ms=None)
                                                for s in _capture().spans))
    monkeypatch.setattr(timing, "last_trace", lambda: host_only)
    if name.endswith("device_ms") or name.endswith("merge_ms"):
        assert read({}) is None   # no CUDA events off the card
    monkeypatch.delattr(timing, "last_trace")   # a program without the recorder
    assert read({}) is None
