"""A run with the timed path broken underneath must come out not correct:
once for each fault these cells can have. The harness's look for a card is
skipped (the run is on the CPU at a tiny size); the rest of the run is
whole. The cells keep no state between steps and span one card, so the
faults of a state left unchanged and of an exchange between cards do not
apply."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny


def _run(tmp_path):
    root = tiny.make_root(tmp_path, mix=tiny.traffic(check_studies=2))
    return harness.run_cell(root, "tiny.mix", 4242, 1.0, False, "cpu", time.perf_counter())


def test_sound_run_is_correct(tmp_path):
    r = _run(tmp_path)
    assert r["correct"], r["checks"]


def test_answer_altered_where_produced(tmp_path, monkeypatch):
    from boa_tpu_torch.inference import predictor

    orig = predictor.sliding_window_seg_chunked

    def altered(*a, **kw):
        seg = orig(*a, **kw)
        n = int(a[4])
        half = seg.shape[0] // 2
        seg[:half] = ((seg[:half].long() + 1) % n).to(seg.dtype)
        return seg

    monkeypatch.setattr(predictor, "sliding_window_seg_chunked", altered)
    r = _run(tmp_path)
    assert not r["correct"]
    assert r["checks"]["gap_p999"]["value"] > r["checks"]["gap_p999"]["limit"]


def test_half_the_tiles_left_out(tmp_path, monkeypatch):
    from boa_tpu_torch.inference import predictor

    orig = predictor.pp.tile_starts

    class HalfTiles:
        def __getattr__(self, name):
            return getattr(predictor.__dict__["_pp_orig"], name)

        @staticmethod
        def tile_starts(*a, **kw):
            return orig(*a, **kw)[::2]

    monkeypatch.setitem(predictor.__dict__, "_pp_orig", predictor.pp)
    monkeypatch.setattr(predictor, "pp", HalfTiles())
    r = _run(tmp_path)
    assert not r["correct"]


def test_labels_shifted_in_space(tmp_path, monkeypatch):
    """The back-resample or orientation off by a voxel: only label borders move."""
    from boa_tpu_torch.inference import pipeline

    orig = pipeline.nifti.apply_orientation

    def shifted(data, ornt):
        out = orig(data, ornt)
        return np.roll(out, 2, axis=0) if out.dtype == np.uint8 else out

    monkeypatch.setattr(pipeline.nifti, "apply_orientation", shifted)
    r = _run(tmp_path)
    assert not r["correct"]
