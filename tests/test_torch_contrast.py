"""The port's contrast prediction against the reference's, on the CPU: the
UBJSON decoder (io/ubjson.py), the numpy tree walker (compute/xgb.py) on
the vendored phase pickle and GIT folds, the pi-time phase
(tools/get_phase.py), `compute/contrast.py:predict` with and without a
trained sklearn bundle, `analyze_ct`'s contrast rows with a bundle, and the
GBM fitter (compute/gbm.py), on features made from a seed with numpy.

Bars: tree margins and probabilities within 1e-6; the feature dicts and
`predict`'s result dicts equal (NaN where the reference has NaN); a fitted
bundle's probabilities and the fitter's model documents equal.
"""

import json
import math
import shutil
import struct

import numpy as np
import pytest

from boa_tpu.compute import contrast as jcon
from boa_tpu.compute import xgb as jxgb
from boa_tpu.io import ubjson as jub
from boa_tpu.tools import get_phase as jphase
from boa_tpu_torch.compute import contrast as tcon
from boa_tpu_torch.compute import xgb as txgb
from boa_tpu_torch.io import ubjson as tub
from boa_tpu_torch.tools import get_phase as tphase

RES = tphase._VENDORED_PHASE_PKL.parent


def test_resources_are_byte_copies():
    """The port ships its own copies of the reference's classifier files,
    the modality folds and the brain atlas."""
    names = ["contrast_phase_classifiers_2024_07_19.pkl", "ct_brain_atlas_1mm.nii.gz"] + [
        f"{stem}.{i}" for stem in ("git_contrast_classifiers_boa_tpu.json",
                                   "modality_classifiers_2025_02_24.json",
                                   "modality_classifiers_normalized_2025_02_24.json")
        for i in range(5)]
    assert sorted(p.name for p in RES.iterdir()) == sorted(names)
    for name in names:
        assert (RES / name).read_bytes() == \
            (jphase._VENDORED_PHASE_PKL.parent / name).read_bytes(), name


def _ub_str(s: str) -> bytes:
    b = s.encode()
    return b"U" + struct.pack(">B", len(b)) + b


def _ubjson_doc(seed: int) -> bytes:
    """An object with every marker: scalars, strings, no-ops, typed and
    counted arrays and objects, nested."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=5).astype(">f4")
    i16 = rng.integers(-3000, 3000, 4).astype(">i2")
    body = [
        b"U\x01a" + b"i" + struct.pack(">b", int(rng.integers(-100, 100))),
        b"U\x01b" + b"D" + struct.pack(">d", float(rng.normal())),
        b"U\x01c" + b"S" + _ub_str("text"),
        b"U\x01d" + b"[$d#U\x05" + f32.tobytes(),
        b"U\x01e" + b"[$I#U\x04" + i16.tobytes(),
        b"U\x01f" + b"[" + b"T" + b"F" + b"Z" + b"N" + b"l" + struct.pack(">i", 70000) + b"]",
        b"U\x01g" + b"{#U\x01" + b"U\x01h" + b"L" + struct.pack(">q", 2 ** 40),
        b"U\x01i" + b"C" + b"x",
        b"U\x01j" + b"[#U\x02" + b"U\x07" + b"d" + struct.pack(">f", 0.5),
    ]
    return b"{" + b"".join(body) + b"}"


def _same(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_ubjson_matches_reference(seed):
    blob = _ubjson_doc(seed)
    _same(tub.loads(blob), jub.loads(blob))
    _same(tub.load_auto(blob), jub.load_auto(blob))
    text = json.dumps({"x": [1, 2.5, None], "y": "z"}).encode()
    _same(tub.load_auto(text), jub.load_auto(text))
    with pytest.raises(ValueError):
        tub.loads(blob[:-3])


def _features(rng, n, width, nan_share=0.2):
    x = rng.normal(60, 120, (n, width)).astype(np.float32)
    x[rng.random((n, width)) < nan_share] = np.nan
    return x


def test_phase_pickle_scores_match_reference():
    """The pickled phase regressors, unpickled without xgboost by both
    packages: the same folds, margins and predictions on seeded features."""
    got = txgb.load_pickled_ensembles(tphase._VENDORED_PHASE_PKL)
    want = jxgb.load_pickled_ensembles(jphase._VENDORED_PHASE_PKL)
    assert list(got) == list(want) and len(want) == 5
    x = _features(np.random.default_rng(3), 64, want[next(iter(want))].num_features, 0.0)
    for k in want:
        np.testing.assert_allclose(got[k].predict_margin(x), want[k].predict_margin(x),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[k].predict(x), want[k].predict(x), rtol=1e-6, atol=1e-6)


def test_git_folds_score_match_reference():
    """The vendored GIT folds: margins, probabilities and labels on seeded
    features with NaNs (the trees' default directions)."""
    got = txgb.load_fold_files(tcon._VENDORED_GIT_FOLDS)
    want = jxgb.load_fold_files(jcon._VENDORED_GIT_FOLDS)
    assert len(got) == len(want) == 5
    x = _features(np.random.default_rng(4), 96, len(tcon.FEATURE_ORGANS) * 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.predict_margin(x), w.predict_margin(x), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(g.predict(x), w.predict(x), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g.predict_label(x), w.predict_label(x))


def test_multiclass_tree_walker_matches_reference():
    """A small softprob model document (two classes' trees interleaved)."""
    def tree(split, cond, leaves):
        return {"split_indices": [split, 0, 0], "split_conditions": [cond, *leaves],
                "left_children": [1, -1, -1], "right_children": [2, -1, -1],
                "default_left": [1, 0, 0], "categories": []}

    doc = {"learner": {
        "gradient_booster": {"name": "gbtree", "model": {
            "trees": [tree(0, 0.5, (0.3, -0.2)), tree(1, -1.0, (0.1, 0.4)),
                      tree(1, 2.0, (-0.5, 0.25)), tree(0, 0.0, (0.05, -0.15))],
            "tree_info": [0, 1, 0, 1]}},
        "learner_model_param": {"num_class": "2", "base_score": "0.5", "num_feature": "2"},
        "objective": {"name": "multi:softprob"}}}
    x = _features(np.random.default_rng(5), 40, 2)
    g, w = txgb.TreeEnsemble.from_model_doc(doc), jxgb.TreeEnsemble.from_model_doc(doc)
    np.testing.assert_allclose(g.predict(x), w.predict(x), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(g.predict_label(x), w.predict_label(x))


def test_pi_time_and_phase_match_reference(monkeypatch):
    for t in np.linspace(-5, 130, 271):
        assert tphase.pi_time_to_phase(float(t)) == jphase.pi_time_to_phase(float(t))
    rng = np.random.default_rng(6)
    for _ in range(6):
        stats = {o: {"intensity": float(rng.normal(100, 80))}
                 for o in tphase.PHASE_ORGANS if rng.random() < 0.8}
        hn = {o: {"intensity": float(rng.normal(150, 50))} for o in tphase.PHASE_ORGANS_HN}
        assert tphase.features_from_stats(stats, hn) == jphase.features_from_stats(stats, hn)
        assert tphase.get_ct_contrast_phase(stats) == jphase.get_ct_contrast_phase(stats)
        assert tphase._heuristic_pi_time(tphase.features_from_stats(stats)) == \
            jphase._heuristic_pi_time(jphase.features_from_stats(stats))
        monkeypatch.setenv("BOA_PHASE_MODEL", "heuristic")
        assert tphase.get_ct_contrast_phase(stats) == jphase.get_ct_contrast_phase(stats)
        monkeypatch.delenv("BOA_PHASE_MODEL")
    with pytest.raises(FileNotFoundError):
        tphase.get_ct_contrast_phase({}, model_file="/nonexistent.pkl")


def _measurements(seed):
    """A total-measurements.json with seeded HU statistics: every contrast
    and phase organ, a share of them absent."""
    rng = np.random.default_rng(seed)
    regions = {}
    for organ in sorted(set(tcon.FEATURE_ORGANS) | set(tphase.PHASE_ORGANS)):
        present = bool(rng.random() < 0.8)
        med = float(rng.normal(120, 90))
        regions[organ] = {"present": present, "volume_ml": float(rng.uniform(1, 900)),
                          "mean_hu": med + float(rng.normal(0, 5)),
                          "std_hu": float(rng.uniform(5, 40)), "median_hu": med,
                          "25th_percentile_hu": med - float(rng.uniform(5, 30)),
                          "75th_percentile_hu": med + float(rng.uniform(5, 30)),
                          "cnr": float(rng.normal(3, 2))}
    return {"segmentations": {"total": regions}, "info": {"autochthon_std": 10.0}}


def _same_result(got, want):
    assert list(got) == list(want)
    for k in want:
        if k == "features":
            assert list(got[k]) == list(want[k])
            for f, v in want[k].items():
                assert (math.isnan(v) and math.isnan(got[k][f])) or got[k][f] == v, f
        else:
            assert type(got[k]) is type(want[k]) and got[k] == want[k], k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_predict_matches_reference(tmp_path, seed):
    m = _measurements(seed)
    (tmp_path / "total-measurements.json").write_text(json.dumps(m))
    tf, jf = tcon.features_from_measurements(m), jcon.features_from_measurements(m)
    assert list(tf) == list(jf)
    np.testing.assert_array_equal(tcon.feature_vector(tf), jcon.feature_vector(jf))
    _same_result(tcon.predict(None, tmp_path), jcon.predict(None, tmp_path))


def test_git_model_env_behaves_as_reference(tmp_path, monkeypatch):
    """BOA_GIT_MODEL=heuristic, a fold stem of one's own (three folds) and a
    stem with no files give the reference's result dicts."""
    m = _measurements(9)
    (tmp_path / "total-measurements.json").write_text(json.dumps(m))
    stem = tmp_path / "byo" / "git"
    stem.parent.mkdir()
    for i in range(3):
        shutil.copy(f"{tcon._VENDORED_GIT_FOLDS}.{i + 1}", f"{stem}.{i}")
    for env in ("heuristic", str(stem), str(tmp_path / "missing")):
        monkeypatch.setenv("BOA_GIT_MODEL", env)
        _same_result(tcon.predict(None, tmp_path), jcon.predict(None, tmp_path))
    monkeypatch.setenv("BOA_GIT_MODEL", "heuristic")
    feats = tcon.features_from_measurements(m)
    assert tcon._heuristic_git(feats) == jcon._heuristic_git(feats)


def test_predict_without_measurements_matches_reference(tmp_path):
    """No total-measurements.json: features from the CT and total.nii.gz
    (one pass over the files) and the heuristic phase, as the reference."""
    from boa_tpu_torch.io import nifti as tn
    from boa_tpu_torch.tasks import class_maps

    rng = np.random.default_rng(10)
    inv = {n: i for i, n in class_maps.get_class_map("total").items()}
    seg = np.zeros((24, 20, 16), np.uint8)
    for k, organ in enumerate(["aorta", "liver", "stomach", "colon", "portal_vein_and_splenic_vein"]):
        seg[k * 4:k * 4 + 4, 2:18, 2:14] = inv[organ]
    ct = rng.integers(-100, 300, seg.shape).astype(np.int16)
    aff = np.diag([1.5, 1.5, 3.0, 1.0])
    tn.save(tn.NiftiImage(data=ct, affine=aff), tmp_path / "ct.nii.gz")
    tn.save(tn.NiftiImage(data=seg, affine=aff), tmp_path / "total.nii.gz")
    _same_result(tcon.predict(tmp_path / "ct.nii.gz", tmp_path),
                 jcon.predict(tmp_path / "ct.nii.gz", tmp_path))
    f = tcon.extract_features(ct, seg)
    assert tcon._heuristic_phase(f) == jcon._heuristic_phase(f)


def _bundle_data(seed: int, n: int = 48):
    """Seeded feature rows (a share NaN, as absent organs give) with phase
    and GIT labels that depend on them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(100, 80, (n, len(tcon.FEATURE_ORGANS) * len(tcon.FEATURE_STATS)))
    x[rng.random(x.shape) < 0.1] = np.nan
    phase = np.digitize(np.nan_to_num(x[:, 2], nan=0.0), [60.0, 140.0])
    git = (np.nan_to_num(x[:, -3], nan=0.0) > 100.0).astype(int)
    return x.astype(np.float32), phase, git


@pytest.fixture()
def one_thread():
    """sklearn's fits and predictions on one thread: the suite's workers
    share the cores, and the small models gain nothing from more."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield


@pytest.mark.usefixtures("one_thread")
def test_contrast_bundle_scores_as_reference(tmp_path, monkeypatch):
    """A bundle fitted by the port's `fit_contrast_model` equals the
    reference's on the same rows (the same sklearn models, so the same
    probabilities to the bit), and `predict` with it, named by
    BOA_CONTRAST_MODEL, an explicit path or the home default, gives the
    reference's result dict, `git_classifier_is_standin` False."""
    x, phase, git = _bundle_data(3)
    tb = tcon.fit_contrast_model(x, phase, git, n_ensemble=2, out_path=tmp_path / "t.pkl")
    jb = jcon.fit_contrast_model(x, phase, git, n_ensemble=2, out_path=tmp_path / "j.pkl")
    assert tb["feature_names"] == jb["feature_names"]
    probe = np.nan_to_num(_bundle_data(4, 12)[0], nan=-1024.0)
    for key in ("phase_models", "git_models"):
        for tm, jm in zip(tb[key], jb[key], strict=True):
            np.testing.assert_array_equal(tm.predict_proba(probe), jm.predict_proba(probe))
    monkeypatch.setenv("HOME", str(tmp_path))
    for seed in (5, 6):
        (tmp_path / "total-measurements.json").write_text(json.dumps(_measurements(seed)))
        monkeypatch.setenv("BOA_CONTRAST_MODEL", str(tmp_path / "t.pkl"))
        got = tcon.predict(None, tmp_path)
        monkeypatch.setenv("BOA_CONTRAST_MODEL", str(tmp_path / "j.pkl"))
        _same_result(got, jcon.predict(None, tmp_path))
        assert not got["git_classifier_is_standin"]
        monkeypatch.delenv("BOA_CONTRAST_MODEL")
        _same_result(tcon.predict(None, tmp_path, model_path=tmp_path / "t.pkl"),
                     jcon.predict(None, tmp_path, model_path=tmp_path / "j.pkl"))
    (tmp_path / ".boa_tpu").mkdir()
    shutil.copy(tmp_path / "t.pkl", tmp_path / ".boa_tpu" / "contrast_model.pkl")
    _same_result(tcon.predict(None, tmp_path), jcon.predict(None, tmp_path))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("bundle", ["fitted", "unreadable"])
def test_analyze_ct_with_contrast_bundle_matches_reference(tmp_path, monkeypatch, bundle):
    """`analyze_ct` with BOA_CONTRAST_MODEL set, through the anatomy
    phantom's hook in both packages: a fitted bundle gives the reference's
    contrast rows and stats; one that cannot be read (as a sklearn pickle
    where sklearn is missing) fails the contrast stage alone, as in the
    reference: the workbook is written without contrast rows and the
    traceback lands in debug_information.txt."""
    from boa_tpu.commands import analyze_ct as janalyze
    from boa_tpu.io import xlsx as jx
    from boa_tpu.testing import anatomy as janat
    from boa_tpu_torch.commands import analyze_ct as tanalyze
    from boa_tpu_torch.io import nifti as tn
    from boa_tpu_torch.testing import anatomy as tanat

    monkeypatch.setenv("BOA_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    monkeypatch.delenv("BOA_GIT_MODEL", raising=False)
    path = tmp_path / "bundle.pkl"
    if bundle == "fitted":
        tcon.fit_contrast_model(*_bundle_data(7), n_ensemble=2, out_path=path)
    else:
        path.write_bytes(b"")
    monkeypatch.setenv("BOA_CONTRAST_MODEL", str(path))
    shape, spacing = (96, 96, 32), (3.5, 3.5, 9.0)
    tn.save(tn.NiftiImage(data=tanat.synth_ct(shape=shape, spacing=spacing),
                          affine=np.diag([*spacing, 1.0])), tmp_path / "ct.nii.gz")
    kw = dict(models=["total"], bca_pdf=False, total_preview=False, fast_total=True)
    want_path, want_stats = janalyze(tmp_path / "ct.nii.gz", tmp_path / "ref", tmp_path / "ref",
                                     fake_predict=janat.fake_predict_factory(), **kw)
    got_path, got_stats = tanalyze(tmp_path / "ct.nii.gz", tmp_path / "got", tmp_path / "got",
                                   fake_predict=tanat.fake_predict_factory(), device="cpu", **kw)
    rows = [{r[0]: r[1] for r in jx.read_xlsx(p)["info"] if r and r[0].startswith("Predicted")}
            for p in (got_path, want_path)]
    assert rows[0] == rows[1]
    for key in ("iv_contrast_phase", "git_contrast"):
        assert got_stats.get(key) == want_stats.get(key), key
    debug = (tmp_path / "got" / "debug_information.txt").read_text()
    if bundle == "fitted":
        assert set(rows[0]) == {"PredictedContrastPhase", "PredictedContrastInGIT"}
        assert "Contrast phase prediction failed" not in debug
    else:
        assert rows[0] == {} and "iv_contrast_phase" not in got_stats
        assert "Contrast phase prediction failed" in debug and "Traceback" in debug
        assert (tmp_path / "got" / "total.nii.gz").exists()


def test_missing_bundle_scores_vendored_folds(tmp_path, monkeypatch):
    """A BOA_CONTRAST_MODEL or explicit path that does not exist is ignored,
    as the reference ignores it: the vendored folds score the study, with
    the reference's result."""
    (tmp_path / "total-measurements.json").write_text(json.dumps(_measurements(2)))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("BOA_CONTRAST_MODEL", str(tmp_path / "missing.pkl"))
    got = tcon.predict(None, tmp_path)
    _same_result(got, jcon.predict(None, tmp_path))
    assert got["git_classifier_is_standin"]
    _same_result(tcon.predict(None, tmp_path, model_path=tmp_path / "gone.pkl"),
                 jcon.predict(None, tmp_path, model_path=tmp_path / "gone.pkl"))


@pytest.mark.parametrize("seed,subsample", [(7, 1.0), (11, 0.7)])
def test_fit_gbtree_document_equals_reference(tmp_path, seed, subsample):
    """`compute/gbm.py`: the same rows (NaN among them) and seed give the
    reference's model document, and `save_model_doc` its bytes."""
    from boa_tpu.compute import gbm as jgbm
    from boa_tpu_torch.compute import gbm as tgbm

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (160, 5)).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 2]) > 0).astype(int)
    x[rng.random(x.shape) < 0.08] = np.nan
    kw = dict(n_rounds=8, max_depth=3, subsample=subsample, seed=seed,
              feature_names=[f"f{i}" for i in range(5)])
    got, want = tgbm.fit_gbtree(x, y, **kw), jgbm.fit_gbtree(x, y, **kw)
    assert got == want
    tgbm.save_model_doc(got, tmp_path / "t.json")
    jgbm.save_model_doc(want, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    np.testing.assert_array_equal(txgb.TreeEnsemble.from_model_doc(got).predict(x),
                                  jxgb.TreeEnsemble.from_model_doc(want).predict(x))
