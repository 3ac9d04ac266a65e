"""The port's `predict_image` beyond the fast study against the reference
(boa_tpu), same inputs made with numpy, on the CPU: the task and class-map
tables, the fake-predict hook through every option of the pipeline (the
five-model merge, crop masks, task-space fakes, the device copy, one-hot
back-resampling, blob removal, remove-outside, probability export), and
real synthetic models through the five-model `total` (the predictor's
general path at a 6 mm plan spacing, its fused path at 1.5 mm) and a crop
task.

Bars: the fake-hook outputs are identical to the reference's, probabilities
within 2e-3; the real `total` labels agree > 0.995 in float32 and > 0.99 in
bf16 (tests/test_torch_pipeline.py's bars, where the port runs its row-conv
composite and the reference its eager forward).
"""

import dataclasses
import pickle

import numpy as np
import pytest

from boa_tpu.inference import pipeline as jpipe
from boa_tpu.io.nifti import NiftiImage as JImage
from boa_tpu.measure import statistics as jst
from boa_tpu.plans.plans import ModelPlans as JPlans
from boa_tpu.tasks import class_maps as jcm
from boa_tpu.tasks import registry as jreg
from boa_tpu.weights import convert as jcv
from boa_tpu.weights.store import ModelStore as JStore
from boa_tpu.weights.store import create_synthetic_model
from boa_tpu_torch.inference import pipeline as tpipe
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.measure import statistics as tst
from boa_tpu_torch.tasks import class_maps as tcm
from boa_tpu_torch.tasks import registry as treg
from boa_tpu_torch.weights.store import ModelStore

AFFINE = np.array([[-0.9, 0, 0, 100], [0, -0.9, 0, 80], [0, 0, 1.5, -200],
                   [0, 0, 0, 1.0]])
PARTS = {291: "part1_organs", 292: "part2_vertebrae", 293: "part3_cardiac",
         294: "part4_muscles", 295: "part5_ribs"}


def _outcome(fn, name, fast):
    try:
        return dataclasses.asdict(fn(name, fast=fast))
    except ValueError as e:
        return type(e)


def test_tables_match_reference():
    for name in ("TASKS", "BCA_TASKS", "_FAST_VARIANTS"):
        assert getattr(treg, name).keys() == getattr(jreg, name).keys(), name
    for name, cfg in list(treg.TASKS.items()) + list(treg.BCA_TASKS.items()):
        ref = {**jreg.TASKS, **jreg.BCA_TASKS}[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        for fast in (False, True):
            for fn in ("get_task", "resolve_task"):
                assert _outcome(getattr(treg, fn), name, fast) == \
                    _outcome(getattr(jreg, fn), name, fast), (fn, name, fast)
        if name in jcm.class_map or name in jpipe._CLASS_MAP_KEY:
            assert tpipe.class_map_for_task(name) == jpipe.class_map_for_task(name)
    with pytest.raises(KeyError):
        treg.get_task("no_such_task")
    for table in ("class_map", "class_map_5_parts", "map_taskid_to_partname",
                  "commercial_models"):
        t, j = getattr(tcm, table), getattr(jcm, table)
        assert list(t.keys()) == list(j.keys()), table
        for k in j.keys():
            assert t[k] == j[k], (table, k)
    assert len(tcm.class_map) == 50 and len(tcm.get_class_map("total")) == 117


def _images(shape=(40, 38, 30), seed=3, affine=AFFINE):
    data = np.random.default_rng(seed).integers(-1000, 1200, size=shape).astype(np.int16)
    return JImage(data=data, affine=affine.copy()), NiftiImage(data=data, affine=affine.copy())


def _mask(shape, box):
    m = np.zeros(shape, np.uint8)
    m[box] = 1
    return JImage(data=m, affine=AFFINE.copy()), NiftiImage(data=m, affine=AFFINE.copy())


def _blocks(shape, seed, n_labels, block=4):
    """Blocky random labels in [0, n_labels) on `shape` (depends on the
    shape and the seed only)."""
    coarse = np.random.default_rng(seed).integers(
        0, n_labels, tuple(-(-n // block) for n in shape))
    out = np.kron(coarse, np.ones((block,) * 3, np.int64))
    return out[:shape[0], :shape[1], :shape[2]].astype(np.uint8)


def _part_fake(vol, spacing, tid):
    part = jcm.class_map_5_parts[jcm.map_taskid_to_partname[tid]]
    seg = _blocks(vol.shape, tid, max(part) + 1)
    seg[_blocks(vol.shape, tid + 1, 2) == 0] = 0  # parts overlap in places
    return seg


def _total_fake(vol, spacing, tid):
    assert tid == -1
    return _blocks(vol.shape, 11, 118)


_total_fake.total_space = True


def _speckle_fake(vol, spacing, tid):
    seg = _blocks(vol.shape, 5, 4, block=2)
    seg[np.random.default_rng(6).random(vol.shape) < 0.05] = 7
    return seg


def _body_images():
    """Air around a 40 x 40 body in a 160 x 160 field: the in-plane body
    crop applies, and the fake hook paints on the full model grid."""
    data = np.full((160, 160, 12), -1000, np.int16)
    data[50:90, 60:100] = np.random.default_rng(9).integers(-200, 400, (40, 40, 12))
    return JImage(data=data, affine=AFFINE.copy()), NiftiImage(data=data, affine=AFFINE.copy())


def _run(task, fake, mask_box=None, body=False, **kw):
    (ij, it), masks = _body_images() if body else _images(), None
    if mask_box is not None:
        masks = _mask(ij.shape, mask_box)
    store = "/nonexistent"
    ref = jpipe.predict_image(ij, task, JStore(store), fake_predict=fake,
                              crop_mask=None if masks is None else masks[0], **kw)
    got = tpipe.predict_image(it, task, ModelStore(store), fake_predict=fake,
                              crop_mask=None if masks is None else masks[1],
                              device="cpu", **kw)
    return ref, got


def _capture_stats_inputs(monkeypatch) -> dict:
    """Records the (seg, ct, args, kwargs) that each pipeline hands its
    get_basic_statistics, under "ref" and "got"."""
    seen: dict = {}

    def wrap(key, fn):
        def f(seg, ct, *a, **kw):
            seen[key] = (np.asarray(seg), np.asarray(ct), a, kw)
            return fn(seg, ct, *a, **kw)
        return f

    monkeypatch.setattr(jst, "get_basic_statistics", wrap("ref", jst.get_basic_statistics))
    monkeypatch.setattr(tpipe, "get_basic_statistics",
                        wrap("got", tpipe.get_basic_statistics))
    return seen


def _stats_bar(ref, seen) -> float:
    """Checks the statistics step on the reference's own inputs to 1e-3 HU
    and returns the end-to-end bar. Both pipelines truncate their float32
    order-3 resample to integers, so where a constant integer region (air
    at -1000) comes out within rounding of that integer, the two model-grid
    CTs differ by 1 HU; a mean or a median then moves by at most 1 HU. On
    the normalized scale, HU are over the CT's range."""
    seg_j, ct_j, a_j, kw_j = seen["ref"]
    seg_t, ct_t, a_t, kw_t = seen["got"]
    np.testing.assert_array_equal(seg_t, seg_j)
    assert a_t == a_j and kw_t == kw_j
    d = int(np.abs(ct_t.astype(np.int64) - ct_j).max())
    assert d <= 1
    hu = 1.0
    if kw_j["normalized_intensities"]:
        # the normalization's ends agree, so a voxel's change scales by one range
        assert (ct_t.min(), ct_t.max()) == (ct_j.min(), ct_j.max())
        hu /= float(ct_j.max()) - float(ct_j.min())
    again = tst.get_basic_statistics(seg_j, ct_j, *a_j, device="cpu", **kw_j)
    assert list(again) == list(ref.stats)
    for name, want in ref.stats.items():
        assert again[name]["volume"] == want["volume"], name
        np.testing.assert_allclose(again[name]["intensity"], want["intensity"],
                                   atol=1e-3 * hu)
    return max(1e-3, d) * hu + (1e-5 if d else 0.0)   # each side rounds to 5 decimals


def _same(ref, got, atol=1e-3):
    if ref.stats is None:
        assert got.stats is None
    else:   # volumes equal, intensities within `atol` (the reference sums in float32)
        assert list(got.stats) == list(ref.stats)
        for name, want in ref.stats.items():
            assert got.stats[name]["volume"] == want["volume"], name
            np.testing.assert_allclose(got.stats[name]["intensity"], want["intensity"],
                                       atol=atol)
        assert sum(w["volume"] > 0 for w in ref.stats.values()) > 5
    np.testing.assert_array_equal(got.seg.data, np.asarray(ref.seg.data))
    assert got.seg.data.dtype == np.uint8
    np.testing.assert_allclose(got.seg.affine, ref.seg.affine)
    assert got.seg.get_label_map() == ref.seg.get_label_map()
    assert got.label_map == ref.label_map
    if ref.seg_model_grid is None:
        assert got.seg_model_grid is None
    else:
        np.testing.assert_array_equal(got.seg_model_grid.data,
                                      np.asarray(ref.seg_model_grid.data))
        np.testing.assert_allclose(got.seg_model_grid.affine, ref.seg_model_grid.affine)


@pytest.mark.parametrize("case", ["merge", "total_space", "crop_mask", "empty_crop",
                                  "keep_device_seg", "nnunet_resampling",
                                  "remove_small_blobs", "remove_outside", "body_crop",
                                  "statistics", "statistics_options"])
def test_fake_pipeline_matches_reference(case, monkeypatch):
    box = (slice(10, 25), slice(12, 26), slice(8, 20))
    atol = 1e-3   # HU
    seen = _capture_stats_inputs(monkeypatch)
    if case == "merge":
        calls = []

        def fake(vol, spacing, tid):
            calls.append(tid)
            return _part_fake(vol, spacing, tid)

        ref, got = _run("total", fake)
        assert calls == [291, 292, 293, 294, 295] * 2
        assert len(np.unique(got.seg.data)) > 20
    elif case == "total_space":
        ref, got = _run("total", _total_fake)
        # the split into parts and the merge give back the task-space fake
        back = _total_fake(np.zeros(got.seg_model_grid.shape), None, -1)
        np.testing.assert_array_equal(got.seg_model_grid.data, back)
    elif case == "crop_mask":
        ref, got = _run("cerebral_bleed", lambda v, s, t: _blocks(v.shape, 2, 3),
                        mask_box=box)
        assert got.seg.data[0:2].sum() == 0 and got.seg.data.any()
    elif case == "empty_crop":
        ref, got = _run("liver_vessels", lambda *a: 1 / 0, mask_box=(slice(0, 0),) * 3)
        assert not got.seg.data.any()
    elif case == "keep_device_seg":
        ref, got = _run("body_regions", lambda v, s, t: _blocks(v.shape, 3, 10, 3),
                        keep_device_seg=True)
        np.testing.assert_array_equal(got.seg_dev_full.numpy(), got.seg.data)
        # a crop mask gives no device copy
        _, got_c = _run("cerebral_bleed", lambda v, s, t: _blocks(v.shape, 2, 3),
                        mask_box=box, keep_device_seg=True)
        assert got_c.seg_dev_full is None
    elif case == "nnunet_resampling":
        ref, got = _run("total_fastest", lambda v, s, t: _blocks(v.shape, 4, 118, 2),
                        nnunet_resampling=True)
    elif case == "remove_small_blobs":
        # 3 mm voxels: components under 200 mm³ are those of < 8 voxels
        ref, got = _run("total", _speckle_fake, remove_small_blobs=True, fast=True)
        assert (got.seg_model_grid.data == 7).sum() < (_speckle_fake(
            got.seg_model_grid.data, None, 0) == 7).sum() / 2
    elif case == "statistics":
        # the five-model merge's labels and the resampled CT on the 1.5 mm grid
        ref, got = _run("total", _part_fake, statistics=True)
        atol = _stats_bar(ref, seen)
    elif case == "statistics_options":
        ref, got = _run("total", lambda v, s, t: _blocks(v.shape, 13, 118, 3),
                        statistics=True, fast=True,
                        stats_aggregation="median", stats_normalized_intensities=True,
                        stats_exclude_border=False, body=True)
        assert all(0.0 <= v["intensity"] <= 1.0 for v in got.stats.values())
        atol = _stats_bar(ref, seen)
    elif case == "body_crop":
        ref, got = _run("total", lambda v, s, t: _blocks(v.shape, 12, 30, 3),
                        body=True, fast=True, keep_device_seg=True)
        assert got.seg.data.shape == (160, 160, 12)
        assert got.seg_model_grid.shape[0] < 160 * 0.9 / 3  # the crop applied
        np.testing.assert_array_equal(got.seg_dev_full.numpy(), got.seg.data)
    else:
        ref, got = _run("heartchambers_highres", lambda v, s, t: _blocks(v.shape, 8, 8),
                        mask_box=box)
        assert got.seg.data.any() and not got.seg.data[:, :, :2].any()
    _same(ref, got, atol)


def test_save_probabilities_matches_reference(tmp_path):
    """The per-sub-model `_{tid}` files of the fake hook's one-hot stand-in."""
    ij, it = _images()
    jpipe.predict_image(ij, "total", JStore("/nonexistent"), fake_predict=_part_fake,
                        save_probabilities=tmp_path / "ref" / "probs.npz")
    tpipe.predict_image(it, "total", ModelStore("/nonexistent"), fake_predict=_part_fake,
                        save_probabilities=tmp_path / "got" / "probs.npz", device="cpu")
    for tid in PARTS:
        want = np.load(tmp_path / "ref" / f"probs_{tid}.npz")["probabilities"]
        have = np.load(tmp_path / "got" / f"probs_{tid}.npz")["probabilities"]
        assert have.dtype == np.float16
        np.testing.assert_allclose(have.astype(np.float32), want.astype(np.float32),
                                   atol=2e-3)
        with open(tmp_path / "ref" / f"probs_{tid}.pkl", "rb") as f:
            pw = pickle.load(f)
        with open(tmp_path / "got" / f"probs_{tid}.pkl", "rb") as f:
            assert pickle.load(f) == pw


def _write_model(root, tid, name, trainer, num_classes, spacing, features, patch=16,
                 background_lead=None):
    """A synthetic model folder from the reference's writer, its seg head
    biased with N(0, 3) so the labels form regions instead of near-ties;
    with `background_lead`, background's bias leads the largest other by it
    (a sub-model then leaves room to the ones before it)."""
    mdir = create_synthetic_model(root, tid, name, num_classes=num_classes,
                                  trainer=trainer, patch_size=(patch,) * 3,
                                  spacing=spacing, features=features)
    path = mdir / "fold_0" / "checkpoint_final.npz"
    p0 = jcv.load_params_npz(path, JPlans.from_model_folder(mdir).arch_config())
    head = p0["seg_heads"][-1]
    head["b"] = head["b"] + np.random.default_rng(7 + tid).normal(
        0, 3.0, head["b"].shape).astype(np.float32)
    if background_lead is not None:
        head["b"][0] = head["b"][1:].max() + background_lead
    jcv.save_params_npz(p0, path)


@pytest.fixture(scope="module")
def total_stores(tmp_path_factory):
    """Five synthetic sub-models 291-295 at a 6 mm plan spacing (the
    predictor resamples: its general path) and at 1.5 mm (the task's own
    grid: the fused path)."""
    roots = {}
    for sp in (6.0, 1.5):
        root = tmp_path_factory.mktemp(f"total_{sp}")
        for tid, name in PARTS.items():
            part = jcm.class_map_5_parts[jcm.map_taskid_to_partname[tid]]
            _write_model(root, tid, name, "nnUNetTrainerNoMirroring", max(part) + 1,
                         (sp,) * 3, (4, 8), background_lead=2.0)
        roots[sp] = root
    return roots


@pytest.mark.parametrize("plan_spacing,dtype,bar", [
    (6.0, "float32", 0.995), (6.0, "bfloat16", 0.99),
    (1.5, "float32", 0.995), (1.5, "bfloat16", 0.99)])
def test_real_total_matches_reference(total_stores, plan_spacing, dtype, bar):
    ij, it = _images((40, 36, 32))
    root = total_stores[plan_spacing]
    ref = jpipe.predict_image(ij, "total", JStore(root), compute_dtype=dtype)
    spans: dict = {}
    got = tpipe.predict_image(it, "total", ModelStore(root), compute_dtype=dtype,
                              device="cpu", spans=spans)
    want = np.asarray(ref.seg.data)
    assert got.seg.data.shape == want.shape == ij.shape
    assert set(np.unique(got.seg.data)) - {0} <= set(got.label_map)
    agree = (got.seg.data == want).mean()
    assert agree > bar, f"label agreement {agree}"
    parts = {tcm.map_taskid_to_partname[t] for t in PARTS
             if np.isin(want, [k for k, v in got.label_map.items()
                               if v in tcm.class_map_5_parts[
                                   tcm.map_taskid_to_partname[t]].values()]).any()}
    assert len(parts) >= 3  # the merge saw labels of several sub-models
    assert all(f"predict_{t}" in spans for t in PARTS)
    assert spans["tiles"] == (5 if plan_spacing == 6.0 else 5 * 12)
    assert spans["float16_accumulators"] == 0   # small logit volumes: float32


@pytest.fixture(scope="module")
def crop_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("liver_vessels")
    _write_model(root, 8, "liver_vessels", "nnUNetTrainer", 3, (1.0,) * 3, (4, 8))
    return root


def test_real_crop_task_matches_reference(crop_store, tmp_path):
    """liver_vessels: crop to a liver box (+20 mm), no task resample, the
    predictor's own resample to its 1 mm plan (general path), float32;
    probabilities through save_probabilities."""
    ij, it = _images((40, 36, 32))
    mj, mt = _mask(ij.shape, (slice(12, 24), slice(10, 22), slice(10, 18)))
    ref = jpipe.predict_image(ij, "liver_vessels", JStore(crop_store), crop_mask=mj,
                              compute_dtype="float32",
                              save_probabilities=tmp_path / "ref.npz")
    got = tpipe.predict_image(it, "liver_vessels", ModelStore(crop_store), crop_mask=mt,
                              compute_dtype="float32", device="cpu",
                              save_probabilities=tmp_path / "got.npz")
    want = np.asarray(ref.seg.data)
    assert got.seg.data.shape == want.shape
    assert (got.seg.data == want).mean() > 0.995 and len(np.unique(want)) > 1
    pw = np.load(tmp_path / "ref.npz")["probabilities"].astype(np.float32)
    ph = np.load(tmp_path / "got.npz")["probabilities"].astype(np.float32)
    assert ph.shape == pw.shape
    np.testing.assert_allclose(ph, pw, atol=2e-3)
