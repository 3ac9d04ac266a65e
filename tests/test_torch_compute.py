"""The port's study orchestration (boa_tpu_torch/compute/inference.py
`compute_all_models`) against the reference's (boa_tpu/compute/inference.py),
through the fake-predict hook on a small CT file with a body crop, on the
CPU: `total` (fast) and the crop task `liver_vessels`; the BCA models
through the anatomy phantom's hook and on small real synthetic models.

Bars: the same file set; the label and ct_pfav files byte-identical;
`total-measurements.json` equal (histogram-derived numbers exactly, the
rest within 1e-6 relative); `total-statistics.json` volumes equal and
intensities within 1e-3 HU (the reference sums in float32).
"""

import json
import logging
import time

import numpy as np
import pytest
import torch

from boa_tpu.compute import inference as jinf
from boa_tpu.io import nifti as jn
from boa_tpu.tasks import class_maps as jcm
from boa_tpu_torch.compute import inference as tinf
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.utils.stages import HostWorker

INV = {n: i for i, n in jcm.get_class_map("total").items()}
MODELS = ["total", "liver_vessels"]


def _blocks(shape, seed, n_labels, block=3):
    coarse = np.random.default_rng(seed).integers(
        0, n_labels, tuple(-(-n // block) for n in shape))
    out = np.kron(coarse, np.ones((block,) * 3, np.int64))
    return out[:shape[0], :shape[1], :shape[2]].astype(np.uint8)


def fake(vol, spacing, tid):
    """Labels from the model-grid CT: `total` (task 297) paints blocks of
    all classes in the body, the autochthon on muscle HU and the aorta on
    contrast HU; liver_vessels (task 8) blocks of its 3 labels."""
    if tid != 297:
        return _blocks(vol.shape, tid, 3)
    seg = _blocks(vol.shape, 11, 118)
    seg[vol < -500] = 0
    muscle = (vol >= 0) & (vol <= 100)
    left = np.arange(vol.shape[0])[:, None, None] < vol.shape[0] // 2
    seg[muscle & left] = INV["autochthon_left"]
    seg[muscle & ~left] = INV["autochthon_right"]
    seg[(vol >= 150) & (vol <= 250)] = INV["aorta"]
    return seg


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """A 1.5 x 1.5 x 3 mm CT file, air around the body (the body crop
    applies), muscle, contrast and random tissue, and the reference's run."""
    root = tmp_path_factory.mktemp("study")
    rng = np.random.default_rng(0)
    data = np.full((64, 60, 48), -1000, np.int16)
    data[10:50, 12:48] = rng.integers(-300, 500, (40, 36, 48))
    data[14:40, 16:40, 4:40] = rng.integers(20, 80, (26, 24, 36))
    data[40:48, 16:40, 4:40] = rng.integers(180, 220, (8, 24, 36))
    aff = np.diag([-1.5, -1.5, 3.0, 1.0])
    aff[:3, 3] = (50, 40, -100)
    tn.save(tn.NiftiImage(data=data, affine=aff), root / "ct.nii.gz")
    ref_stats = jinf.compute_all_models(root / "ct.nii.gz", root / "ref", MODELS,
                                        totalsegmentator_params={"fast": True},
                                        store="/nonexistent", fake_predict=fake)
    return root, ref_stats


def _files(folder):
    return sorted(p.name for p in folder.iterdir())


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif want is None or isinstance(want, bool):
        assert got is want, path
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=path)


def _same_outputs(got_dir, ref_dir):
    assert _files(got_dir) == _files(ref_dir) == [
        "ct_pfav.nii.gz", "liver_vessels.nii.gz", "total-measurements.json",
        "total-statistics.json", "total.nii.gz"]
    for name in ("total.nii.gz", "liver_vessels.nii.gz", "ct_pfav.nii.gz"):
        assert (got_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
    got = json.loads((got_dir / "total-measurements.json").read_text())
    want = json.loads((ref_dir / "total-measurements.json").read_text())
    _close(got, want)
    assert want["info"]["autochthon_mean"] is not None and "cnr_adjusted" in want
    got = json.loads((got_dir / "total-statistics.json").read_text())
    want = json.loads((ref_dir / "total-statistics.json").read_text())
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name]["volume"] == w["volume"], name
        np.testing.assert_allclose(got[name]["intensity"], w["intensity"], atol=1e-3)
    assert sum(w["volume"] > 0 for w in want.values()) > 20


class _SlowWorker(HostWorker):
    """Delays every stage, so that a save nobody waits for is still in
    flight when compute_all_models returns."""

    def submit(self, name, fn, *args, **kwargs):
        def late(*a, **kw):
            time.sleep(0.3)
            return fn(*a, **kw)
        return super().submit(name, late, *args, **kwargs)


@pytest.mark.parametrize("worker", [False, True])
def test_outputs_match_reference(study, tmp_path, worker):
    root, ref_stats = study
    spans: dict = {}
    images: dict = {}
    kw = dict(totalsegmentator_params={"fast": True}, fake_predict=fake, device="cpu",
              spans=spans, images_out=images)
    if worker:
        with _SlowWorker() as w:
            got_stats = tinf.compute_all_models(root / "ct.nii.gz", tmp_path, MODELS,
                                                worker=w, **kw)
            # every file is written when compute_all_models returns
            _same_outputs(tmp_path, root / "ref")
    else:
        got_stats = tinf.compute_all_models(root / "ct.nii.gz", tmp_path, MODELS, **kw)
        _same_outputs(tmp_path, root / "ref")
    assert got_stats == ref_stats
    assert list(images) == MODELS
    assert {"load", "body_crop", "predict", "statistics", "measure_inputs",
            "total.histogram", "autochthon", "total.cnr_adjusted", "pfav", "save",
            "save_wait"} <= set(spans)


def test_recompute_false_skips_and_measures_from_files(study, tmp_path):
    """A second run with recompute=False predicts nothing; with the
    measurement file gone it measures from the label files on disk (full
    grid, cut to this run's body crop)."""
    root, _ = study
    kw = dict(totalsegmentator_params={"fast": True}, device="cpu")
    tinf.compute_all_models(root / "ct.nii.gz", tmp_path, MODELS, fake_predict=fake, **kw)
    before = {p.name: p.stat().st_mtime_ns for p in tmp_path.iterdir()}

    def no_call(*a):
        raise AssertionError("a computed model ran again")

    tinf.compute_all_models(root / "ct.nii.gz", tmp_path, MODELS, recompute=False,
                            fake_predict=no_call, **kw)
    assert {p.name: p.stat().st_mtime_ns for p in tmp_path.iterdir()} == before
    (tmp_path / "total-measurements.json").unlink()
    (tmp_path / "ct_pfav.nii.gz").unlink()
    tinf.compute_all_models(root / "ct.nii.gz", tmp_path, MODELS, recompute=False,
                            fake_predict=no_call, **kw)
    _same_outputs(tmp_path, root / "ref")


@pytest.mark.parametrize("models,params,bca_params", [
    (["total"], {"preview": True}, None),
    (["total", "bca"], {}, None), (["bca"], {}, {"save_pdf": True}),
])
def test_unported_parts_raise(study, bca_study, tmp_path, models, params, bca_params):
    """The preview and the BCA PDF (the default of save_pdf), which raised
    until their renderers were ported (ROADMAP M9 (i)), now write
    preview_total.png and report.pdf beside the study's other files, as
    the reference does (tests/test_commands.py)."""
    from boa_tpu_torch.testing import anatomy as tanat

    root = study[0] if models == ["total"] else bca_study
    tinf.compute_all_models(root / "ct.nii.gz", tmp_path, models,
                            totalsegmentator_params={"fast": True, **params},
                            bca_params=bca_params, device="cpu",
                            fake_predict=fake if models == ["total"]
                            else tanat.fake_predict_factory())
    want = {"preview_total.png"} if params else {"report.pdf", *BCA_FILES["bca"]}
    if "total" in models:
        want |= {"ct_pfav.nii.gz", "total-measurements.json", "total-statistics.json",
                 "total.nii.gz"}
    else:
        want.discard("vertebrae.json")   # the vertebra windows come from total
    assert set(_files(tmp_path)) == want
    render = tmp_path / ("preview_total.png" if params else "report.pdf")
    assert render.stat().st_size > 1000


@pytest.mark.parametrize("worker", [False, True])
def test_failed_preview_keeps_the_study(study, tmp_path, monkeypatch, caplog, worker):
    """A preview render that raises is logged as a warning, as the
    reference logs it, inline or on the HostWorker, and every other file
    of the study is written as without the preview."""
    from boa_tpu_torch.compute import preview as tprev

    def broken(*a):
        raise RuntimeError("injected render failure")

    monkeypatch.setattr(tprev, "_render_montage", broken)
    caplog.set_level(logging.WARNING)
    root, _ = study
    kw = dict(totalsegmentator_params={"fast": True, "preview": True}, fake_predict=fake,
              device="cpu")
    if worker:
        with HostWorker() as w:
            tinf.compute_all_models(root / "ct.nii.gz", tmp_path, MODELS, worker=w, **kw)
    else:
        tinf.compute_all_models(root / "ct.nii.gz", tmp_path, MODELS, **kw)
    _same_outputs(tmp_path, root / "ref")
    assert ("Deferred stage preview-render failed" if worker
            else "Preview generation failed") in caplog.text


@pytest.fixture(scope="module")
def bca_study(tmp_path_factory):
    """The anatomy phantom as a CT file with air around the body (the body
    crop applies), 600 mm long at 5 mm."""
    from boa_tpu.testing import anatomy

    root = tmp_path_factory.mktemp("bca_study")
    shape, spacing = (96, 88, 120), (5.0, 5.0, 5.0)
    aff = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    aff[:3, 3] = (200, 180, -300)
    tn.save(tn.NiftiImage(data=anatomy.synth_ct(shape, spacing), affine=aff),
            root / "ct.nii.gz")
    return root


BCA_FILES = {"bca": ["bca-measurements.json", "body_parts.nii.gz", "body_regions.nii.gz",
                     "tissues.nii.gz", "vertebrae.json"],
             "body_parts": ["body_parts.nii.gz"], "body_regions": ["body_regions.nii.gz"]}


@pytest.mark.parametrize("models,worker", [
    (["total", "bca"], False), (["total", "bca"], True), (["body_parts"], False),
    (["body_regions"], False)])
def test_bca_models_match_reference(bca_study, tmp_path, models, worker):
    """The BCA half of compute_all_models through the anatomy fake hook in
    both packages: the same files, label files byte-identical, the BCA JSONs
    within tests/test_torch_bca.py's bars, the study stats (with
    `bca_regions`) equal."""
    from boa_tpu.testing import anatomy as janat
    from boa_tpu_torch.testing import anatomy as tanat
    from tests.test_torch_bca import _close

    kw = dict(totalsegmentator_params={"fast": True}, bca_params={"save_pdf": False})
    want = jinf.compute_all_models(bca_study / "ct.nii.gz", tmp_path / "ref", models,
                                   store="/nonexistent",
                                   fake_predict=janat.fake_predict_factory(), **kw)
    spans: dict = {}
    with HostWorker() as w:
        got = tinf.compute_all_models(bca_study / "ct.nii.gz", tmp_path / "got", models,
                                      fake_predict=tanat.fake_predict_factory(),
                                      device="cpu", spans=spans,
                                      worker=w if worker else None, **kw)
    assert got == want
    files = _files(tmp_path / "ref")
    assert _files(tmp_path / "got") == files
    assert set(BCA_FILES[models[-1]]) <= set(files)
    for name in files:
        if name.endswith(".nii.gz"):
            assert (tmp_path / "got" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes(), name
        elif name in ("bca-measurements.json", "vertebrae.json"):
            _close(json.loads((tmp_path / "got" / name).read_text()),
                   json.loads((tmp_path / "ref" / name).read_text()))
    if "bca" in models:
        assert got["bca_regions"] == 3
        bca = json.loads((tmp_path / "got" / "bca-measurements.json").read_text())
        assert bca["body_parts"]["abdomen"] and "l3" in bca["aggregated"]
        assert {"predict", "predict_543", "predict_542", "tissues", "builder",
                "save_wait"} <= set(spans)


def test_bca_real_models_match_reference(tmp_path):
    """body_parts and body_regions on real synthetic models (widths (4, 8),
    16x16x8 patch, 5 mm thickness-only resample; tests/test_bca.py's
    real-model case) with the five folds the registry runs, through
    compute_all_models(["bca"]) in fp32 in both packages: labels agree
    > 0.995, the same files."""
    from boa_tpu.bca.definitions import BodyPart, BodyRegion
    from boa_tpu.weights.store import ModelStore as JStore
    from boa_tpu_torch.weights.store import ModelStore, create_synthetic_model

    root = tmp_path / "models"
    for tid, name, trainer, enum_ in (
            (542, "BCA_body_regions", "nnUNetTrainerNoMirroring", BodyRegion),
            (543, "BCA_body_parts", "nnUNetTrainer_1500epochs_NoMirroring", BodyPart)):
        create_synthetic_model(root, tid, name, num_classes=max(enum_) + 1, trainer=trainer,
                               patch_size=(16, 16, 8), spacing=(1.5, 1.5, 5.0),
                               features=(4, 8), n_folds=5,
                               label_names=[e.name for e in sorted(enum_, key=int) if e])
    data = np.full((40, 36, 16), -1000, np.int16)
    data[8:32, 8:28, :] = np.random.default_rng(1).integers(-200, 200, (24, 20, 16))
    tn.save(tn.NiftiImage(data=data, affine=np.diag([-1.5, -1.5, 3.0, 1.0])),
            tmp_path / "ct.nii.gz")
    params = {"save_pdf": False, "compute_dtype": "float32"}
    jinf.compute_all_models(tmp_path / "ct.nii.gz", tmp_path / "ref", ["bca"],
                            bca_params=params, store=JStore(root))
    tinf.compute_all_models(tmp_path / "ct.nii.gz", tmp_path / "got", ["bca"],
                            bca_params=params, store=ModelStore(root), device="cpu")
    assert _files(tmp_path / "got") == _files(tmp_path / "ref") == [
        "bca-measurements.json", "body_parts.nii.gz", "body_regions.nii.gz",
        "tissues.nii.gz"]
    for name in ("body_parts.nii.gz", "body_regions.nii.gz", "tissues.nii.gz"):
        want = np.asarray(jn.load(tmp_path / "ref" / name).data)
        got = tn.load(tmp_path / "got" / name).data
        assert got.shape == want.shape == data.shape
        assert (got == want).mean() > 0.995 and len(np.unique(want)) > 2, name


def test_defaults_to_cuda(study, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = study
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.compute_all_models(root / "ct.nii.gz", tmp_path, ["total"], fake_predict=fake)


def test_range_warning(caplog):
    assert tinf.range_warning(np.array([-1024, 3071], np.int16)) == (-1024.0, 3071.0)
    assert not caplog.records
    assert tinf.range_warning(np.array([-2000, 10], np.int16)) == \
        jinf.range_warning(np.array([-2000, 10], np.int16))
    assert "Unexpected CT values" in caplog.text


def test_workbook_sheets_match_golden(tmp_path):
    """tests/test_golden_regression.py's study and fake through the port's
    `compute_all_models`; the reference's sheet builder
    (compute/ts_metrics.py) turns its files into the regions-statistics and
    cnr-adjusted sheets, held to tests/data/golden_workbook.json with that
    test's bars (rel 1e-3, abs 1e-6)."""
    import pandas as pd

    from boa_tpu.commands import write_output_workbook
    from boa_tpu.compute import ts_metrics
    from boa_tpu.io import xlsx
    from tests.test_golden_regression import GOLDEN, _fake

    rng = np.random.default_rng(42)
    shape = (64, 64, 48)
    gx = np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None]
    gy = np.linspace(-1, 1, shape[1], dtype=np.float32)[None, :]
    body = (gx ** 2 / 0.6 + gy ** 2 / 0.5) < 1.0
    vol = np.where(body, 40.0, -1000.0).astype(np.float32)[:, :, None] + \
        10 * rng.standard_normal(shape, dtype=np.float32)
    tn.save(tn.NiftiImage(data=vol.astype(np.int16), affine=np.diag([-1.5, -1.5, 3.0, 1.0])),
            tmp_path / "study.nii.gz")
    out = tmp_path / "out"
    tinf.compute_all_models(tmp_path / "study.nii.gz", out, ["total"],
                            totalsegmentator_params={"fast": True}, fake_predict=_fake,
                            cnr_adjustment=True, device="cpu")
    _, regions_df, cnr_df = ts_metrics.compute_segmentator_metrics(tmp_path / "study.nii.gz",
                                                                   out)
    write_output_workbook(out / "output.xlsx", pd.DataFrame(), regions_df, cnr_df)
    golden = json.loads(GOLDEN.read_text())
    sheets = xlsx.read_xlsx(out / "output.xlsx")
    for name in ("regions-statistics", "cnr-adjusted"):
        got, want = sheets[name], golden[name]
        assert len(got) == len(want), f"{name}: row count changed"
        for r, (grow, wrow) in enumerate(zip(got, want)):
            assert len(grow) == len(wrow), f"{name} row {r} width"
            for g, w in zip(grow, wrow):
                if isinstance(w, (int, float)) and not isinstance(w, bool) \
                        and w is not None and g is not None:
                    assert g == pytest.approx(w, rel=1e-3, abs=1e-6), \
                        f"{name} row {r}: {g} != {w}"
                else:
                    assert g == w, f"{name} row {r}: {g!r} != {w!r}"


def test_crop_cascade_matches_reference(tmp_path):
    """liver_vessels through the crop cascade with real synthetic models:
    the low-res `total` (task 297, the liver's head bias tied with the
    largest) gives a liver mask on a two-tissue CT (its box with the 20 mm
    addon covers this small CT; predict_image's crop is tested in
    tests/test_torch_total.py), then
    liver_vessels (task 8, unbiased head) runs on the crop through the
    predictor's general path, in both packages (bf16: labels agree > 0.99,
    tests/test_torch_total.py's bar)."""
    from boa_tpu.plans.plans import ModelPlans as JPlans
    from boa_tpu.weights import convert as jcv
    from boa_tpu.weights.store import ModelStore as JStore
    from tests.test_torch_total import _write_model
    from boa_tpu_torch.weights.store import ModelStore

    root = tmp_path / "models"
    _write_model(root, 297, "total_fast", "nnUNetTrainer_4000epochs_NoMirroring", 118,
                 (3.0,) * 3, (4, 8))
    _write_model(root, 8, "liver_vessels", "nnUNetTrainer", 3, (1.0,) * 3, (4, 8))
    mdir = JStore(root).model_dir(297, "nnUNetTrainer_4000epochs_NoMirroring")
    path = mdir / "fold_0" / "checkpoint_final.npz"
    params = jcv.load_params_npz(path, JPlans.from_model_folder(mdir).arch_config())
    head = params["seg_heads"][-1]
    head["b"][INV["liver"]] = head["b"].max()
    jcv.save_params_npz(params, path)
    mdir = JStore(root).model_dir(8, "nnUNetTrainer")
    path = mdir / "fold_0" / "checkpoint_final.npz"
    params = jcv.load_params_npz(path, JPlans.from_model_folder(mdir).arch_config())
    params["seg_heads"][-1]["b"][:] = 0.0
    jcv.save_params_npz(params, path)
    rng = np.random.default_rng(3)
    data = rng.integers(-50, 50, (40, 36, 32)).astype(np.int16)
    data[20:] += 900
    aff = np.diag([-0.9, -0.9, 1.5, 1.0])
    tn.save(tn.NiftiImage(data=data, affine=aff), tmp_path / "ct.nii.gz")
    jinf.compute_all_models(tmp_path / "ct.nii.gz", tmp_path / "ref", ["liver_vessels"],
                            store=JStore(root))
    tinf.compute_all_models(tmp_path / "ct.nii.gz", tmp_path / "got", ["liver_vessels"],
                            store=ModelStore(root), device="cpu")
    assert _files(tmp_path / "got") == _files(tmp_path / "ref") == [
        "liver_vessels.nii.gz", "total-measurements.json"]
    want = np.asarray(jn.load(tmp_path / "ref" / "liver_vessels.nii.gz").data)
    got = tn.load(tmp_path / "got" / "liver_vessels.nii.gz").data
    assert got.shape == want.shape == data.shape
    assert (got == want).mean() > 0.99 and len(np.unique(want)) > 1
    got_m = json.loads((tmp_path / "got" / "total-measurements.json").read_text())
    want_m = json.loads((tmp_path / "ref" / "total-measurements.json").read_text())
    assert list(got_m["segmentations"]["liver_vessels"]) == \
        list(want_m["segmentations"]["liver_vessels"])


def test_bca_recompute_false_reuses_cropped_files(bca_study, tmp_path):
    """A second run with recompute=False predicts nothing: the BCA label
    files (on the full grid) are cut to the run's body crop and give the
    same report. (The reference fails here: it pairs the full-grid files
    with the cropped CT.)"""
    from boa_tpu_torch.testing import anatomy as tanat

    kw = dict(totalsegmentator_params={"fast": True}, bca_params={"save_pdf": False},
              device="cpu")
    first = tinf.compute_all_models(bca_study / "ct.nii.gz", tmp_path, ["total", "bca"],
                                    fake_predict=tanat.fake_predict_factory(), **kw)
    report = (tmp_path / "bca-measurements.json").read_text()
    labels = {n: (tmp_path / n).read_bytes() for n in BCA_FILES["bca"] if "nii" in n}

    def no_call(*a):
        raise AssertionError("a computed model ran again")

    (tmp_path / "bca-measurements.json").unlink()
    again = tinf.compute_all_models(bca_study / "ct.nii.gz", tmp_path, ["total", "bca"],
                                    recompute=False, fake_predict=no_call, **kw)
    assert again == first
    assert (tmp_path / "bca-measurements.json").read_text() == report
    assert {n: (tmp_path / n).read_bytes() for n in labels} == labels
