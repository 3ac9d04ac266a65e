"""The port's model-folder tools (boa_tpu_torch/engine/) against the
reference's (boa_tpu/engine/) on the same folders: `predict_folder` (parts,
resume, probabilities, `-m` against `-d`, a `.pth` model folder with mirror
TTA, residual and 2d folders, the cascade's automatic chain), the 2d slice
stack of the predictor, `extract_fingerprint`, evaluation and ensembling
with their `main`s. Both packages predict in float32 where they are
compared (as tests/test_torch_predictor.py does: bf16 rounds differently in
XLA and in torch); labels agree with the reference's > 0.995 (the bar of
tests/test_predictor.py); fingerprints, metrics and ensembles are equal to
1e-6; probabilities of the two packages' predictions, float16 files, are
held at the predictor tests' 2e-3 (tests/test_torch_predictor.py)."""

import json
import pickle
import shutil

import numpy as np
import pytest
import torch

from boa_tpu.engine import ensembling as jens
from boa_tpu.engine import evaluation as jeval
from boa_tpu.engine import fingerprint as jfp
from boa_tpu.engine import predict as jep
from boa_tpu.inference import predictor as jpred
from boa_tpu_torch.engine import ensembling as tens
from boa_tpu_torch.engine import evaluation as teval
from boa_tpu_torch.engine import fingerprint as tfp
from boa_tpu_torch.engine import predict as tep
from boa_tpu_torch.inference import predictor as tpred
from boa_tpu_torch.io import nifti
from boa_tpu_torch.plans.plans import ModelPlans, synthetic_plans
from boa_tpu_torch.testing.nnunet_checkpoint import save_checkpoint
from boa_tpu_torch.weights import convert as cv
from boa_tpu_torch.weights.store import (ModelStore, create_synthetic_model,
                                         init_params_numpy)


def _seg(path):
    return np.asarray(nifti.load(path).data)


def _agree(a, b):
    assert a.shape == b.shape
    return float((a == b).mean())


def _cases(in_dir, names, shape=(20, 18, 16), spacing=3.0, seed=0):
    in_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        data = rng.normal(0, 200, size=shape).astype(np.int16)
        nifti.save(nifti.NiftiImage(data=data, affine=np.diag([spacing] * 3 + [1.0])),
                   in_dir / name)
    return in_dir


def _argmax_is_labels(probs, seg):
    """The labels are the argmax of the logits; the float16 probabilities'
    argmax equals them wherever two classes do not round to one float16
    value (np.argmax takes the first of a tie)."""
    diff = np.argmax(probs, 0) != seg
    at_label = np.take_along_axis(probs, seg[None].astype(np.int64), 0)[0]
    np.testing.assert_array_equal(at_label[diff], probs.max(0)[diff])
    assert diff.mean() < 1e-2


def _fp32(monkeypatch):
    """Both packages' predict_folder build their Predictor in float32."""
    for mod in (jpred, tpred):
        cls = mod.Predictor
        monkeypatch.setattr(mod, "Predictor",
                            lambda *a, _c=cls, **k: _c(*a, compute_dtype="float32", **k))


def test_predict_folder_parts_resume_probabilities_and_store(tmp_path, monkeypatch):
    """tests/test_engine.py's folder: part sharding, resume, probabilities
    and `-m` against `-d`, each against the reference's run."""
    _fp32(monkeypatch)
    create_synthetic_model(tmp_path / "w", 901, "Toy", num_classes=3,
                           patch_size=(16, 16, 16), spacing=(3.0, 3.0, 3.0),
                           features=(4, 8))
    in_dir = _cases(tmp_path / "cases", ["caseA_0000.nii.gz", "caseB.nii.gz",
                                         "caseC_0000.nii.gz"])
    store = ModelStore(tmp_path / "w")
    out = tmp_path / "preds"
    w0 = tep.predict_folder(in_dir, out, task_id=901, folds=[0], num_parts=2,
                            part_id=0, store=store, disable_tta=True, device="cpu")
    assert [p.name for p in w0] == ["caseA.nii.gz", "caseC.nii.gz"]
    spans = {}
    w1 = tep.predict_folder(in_dir, out, task_id=901, folds=[0], num_parts=2,
                            part_id=1, store=store, disable_tta=True,
                            save_probabilities=True, device="cpu", spans=spans)
    assert [p.name for p in w1] == ["caseB.nii.gz"]
    assert set(spans) == {"load_weights", "predict", "export"}
    probs = np.load(out / "caseB.npz")["probabilities"]
    assert probs.shape == (3, 20, 18, 16) and probs.dtype == np.float16
    _argmax_is_labels(probs, _seg(out / "caseB.nii.gz"))
    with open(out / "caseB.pkl", "rb") as fh:
        assert pickle.load(fh)["spacing"] == (3.0, 3.0, 3.0)
    assert tep.predict_folder(in_dir, out, task_id=901, folds=[0], store=store,
                              continue_prediction=True, disable_tta=True,
                              device="cpu") == []
    w_m = tep.predict_folder(in_dir, tmp_path / "preds_m", model_dir=store.model_dir(901),
                             folds=[0], disable_tta=True, device="cpu")
    assert len(w_m) == 3
    for cid in ("caseA", "caseC"):
        assert (_seg(out / f"{cid}.nii.gz") == _seg(tmp_path / f"preds_m/{cid}.nii.gz")).all()
    ref_out = tmp_path / "ref"
    jep.predict_folder(in_dir, ref_out, task_id=901, folds=[0], disable_tta=True,
                       store=__import__("boa_tpu.weights.store", fromlist=["x"])
                       .ModelStore(tmp_path / "w"), save_probabilities=True)
    for cid in ("caseA", "caseB", "caseC"):
        assert _agree(_seg(tmp_path / f"preds_m/{cid}.nii.gz"),
                      _seg(ref_out / f"{cid}.nii.gz")) > 0.995
    assert nifti.load(out / "caseB.nii.gz").affine.tolist() == \
        nifti.load(ref_out / "caseB.nii.gz").affine.tolist()


def test_predict_folder_probabilities_match_reference(tmp_path, monkeypatch):
    _fp32(monkeypatch)
    create_synthetic_model(tmp_path / "w", 902, "Toy", num_classes=4,
                           patch_size=(16, 16, 16), features=(4, 8), seed=3)
    in_dir = _cases(tmp_path / "cases", ["c1.nii.gz"], shape=(22, 20, 18), seed=1)
    mdir = ModelStore(tmp_path / "w").model_dir(902)
    tep.predict_folder(in_dir, tmp_path / "p", model_dir=mdir, folds=[0],
                       save_probabilities=True, disable_tta=True, device="cpu")
    jep.predict_folder(in_dir, tmp_path / "r", model_dir=mdir, folds=[0],
                       save_probabilities=True, disable_tta=True)
    got = np.load(tmp_path / "p/c1.npz")["probabilities"].astype(np.float32)
    want = np.load(tmp_path / "r/c1.npz")["probabilities"].astype(np.float32)
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert _agree(_seg(tmp_path / "p/c1.nii.gz"), _seg(tmp_path / "r/c1.nii.gz")) > 0.995
    with open(tmp_path / "p/c1.pkl", "rb") as a, open(tmp_path / "r/c1.pkl", "rb") as b:
        assert pickle.load(a) == pickle.load(b)


def _model_folder(root, plans: ModelPlans, conf: str, seed: int, n_folds=1,
                  trainer="nnUNetTrainer", pth=False) -> "Path":
    """An nnU-Net results folder holding `plans` under `conf`, fold weights
    random from `seed`, as `.npz` or as a real-format `.pth`."""
    mdir = root / "Dataset079_Toy" / f"{trainer}__nnUNetPlans__{conf}"
    mdir.mkdir(parents=True)
    (mdir / "plans.json").write_text(json.dumps(plans.plans))
    (mdir / "dataset.json").write_text(json.dumps(plans.dataset))
    cfg = ModelPlans(plans.plans, plans.dataset, conf).arch_config()
    for f in range(n_folds):
        params = init_params_numpy(cfg, seed + f)
        if pth:
            save_checkpoint(mdir / f"fold_{f}" / "checkpoint_final.pth", params, cfg,
                            trainer_name=trainer, configuration=conf, fold=f)
        else:
            (mdir / f"fold_{f}").mkdir()
            cv.save_params_npz(params, mdir / f"fold_{f}" / "checkpoint_final.npz")
    return mdir


def _residual(plans: ModelPlans, blocks=(1, 2)) -> ModelPlans:
    arch = plans.plans["configurations"]["3d_fullres"]["architecture"]
    arch["network_class_name"] = ("dynamic_network_architectures.architectures."
                                  "residual_unet.ResidualEncoderUNet")
    kw = arch["arch_kwargs"]
    kw["n_blocks_per_stage"] = list(blocks)
    kw["n_conv_per_stage_decoder"] = [1] * (len(blocks) - 1)
    del kw["n_conv_per_stage"]
    return ModelPlans(plans.plans, plans.dataset)


def _two_d(plans: ModelPlans, conf="2d") -> ModelPlans:
    """The 3d_fullres configuration turned into a 2d one (tests/test_2d.py)."""
    c = plans.plans["configurations"].pop("3d_fullres")
    n = c["architecture"]["arch_kwargs"]["n_stages"]
    c["patch_size"] = c["patch_size"][1:]
    c["spacing"] = c["spacing"][1:]
    kw = c["architecture"]["arch_kwargs"]
    kw["kernel_sizes"] = [[3, 3]] * n
    kw["strides"] = [[1, 1]] + [[2, 2]] * (n - 1)
    plans.plans["configurations"][conf] = c
    return ModelPlans(plans.plans, plans.dataset, conf)


@pytest.mark.parametrize("kind", ["pth_tta", "residual", "two_d"])
def test_model_folder_forms_match_reference(tmp_path, monkeypatch, kind):
    """A `.pth` model folder of two folds with nnUNetTrainer's mirror TTA
    (converted by each package from the same files), a residual folder and
    a 2d folder (`-c 2d`, slice stack at native z): labels > 0.995."""
    _fp32(monkeypatch)
    base = synthetic_plans(num_classes=3, patch_size=(16, 16, 16),
                           spacing=(2.0, 2.0, 2.0), features=(4, 8))
    conf, n_folds, tta = "3d_fullres", 1, False
    if kind == "pth_tta":
        plans, n_folds, tta = base, 2, True
    elif kind == "residual":
        plans = _residual(base)
    else:
        plans, conf = _two_d(base), "2d"
    mdir = _model_folder(tmp_path / "t", plans, conf, seed=5, n_folds=n_folds,
                         pth=kind == "pth_tta")
    ref_dir = tmp_path / "r" / mdir.parent.name / mdir.name
    shutil.copytree(mdir, ref_dir)
    in_dir = _cases(tmp_path / "cases", ["k1.nii.gz"], shape=(18, 20, 7), spacing=2.5,
                    seed=6)
    got = tep.predict_folder(in_dir, tmp_path / "p", model_dir=mdir, configuration=conf,
                             disable_tta=not tta, device="cpu")
    want = jep.predict_folder(in_dir, tmp_path / "q", model_dir=ref_dir,
                              configuration=conf, disable_tta=not tta)
    a, b = _seg(got[0]), _seg(want[0])
    assert a.shape == (18, 20, 7)
    assert _agree(a, b) > 0.995
    if kind == "pth_tta":  # each fold converted once, its .npz cached
        assert sorted(p.name for p in mdir.glob("fold_*/*.npz")) == \
            ["checkpoint_final.npz"] * 2
        with pytest.raises(ValueError, match="not in plans.json"):
            tep.load_model_folder(mdir, None, configuration="3d_lowres")


def _cascade_plans() -> ModelPlans:
    """3d_fullres + 3d_lowres + 3d_cascade_fullres (tests/test_cascade.py)."""
    mp = synthetic_plans(num_classes=3, patch_size=(8, 8, 8), spacing=(2.0, 2.0, 2.0),
                         features=(4, 8))
    confs = mp.plans["configurations"]
    low = dict(confs["3d_fullres"], spacing=[4.0, 4.0, 4.0], next_stage="3d_cascade_fullres")
    confs["3d_lowres"] = low
    confs["3d_cascade_fullres"] = {"inherits_from": "3d_fullres",
                                   "previous_stage": "3d_lowres"}
    return mp


@pytest.mark.parametrize("two_d", [False, True])
def test_cascade_autochain_matches_reference(tmp_path, monkeypatch, two_d):
    """`predict_folder` on 3d_cascade_fullres predicts 3d_lowres first from
    the sibling folder into segs_from_prev_stage_3d_lowres (both stages 2d
    plans in the second case); without the sibling it raises."""
    _fp32(monkeypatch)
    mp = _cascade_plans()
    if two_d:
        for c in ("3d_fullres", "3d_lowres"):
            conf = mp.plans["configurations"][c]
            conf["patch_size"], conf["spacing"] = conf["patch_size"][1:], conf["spacing"][1:]
            kw = conf["architecture"]["arch_kwargs"]
            kw["kernel_sizes"], kw["strides"] = [[3, 3]] * 2, [[1, 1], [2, 2]]
    dirs = {c: _model_folder(tmp_path / "m", ModelPlans(mp.plans, mp.dataset, c), c, seed=i)
            for i, c in enumerate(("3d_lowres", "3d_cascade_fullres", "3d_fullres"))}
    vol = np.random.default_rng(7).normal(60.0, 30.0, (20, 20, 20)).astype(np.float32)
    vol[6:14, 6:14, 6:14] += 90
    in_dir = tmp_path / "imgs"
    in_dir.mkdir()
    nifti.save(nifti.NiftiImage(data=vol, affine=np.diag([2.0, 2.0, 2.0, 1.0])),
               in_dir / "case0.nii.gz")
    got = tep.predict_folder(in_dir, tmp_path / "oc", model_dir=dirs["3d_cascade_fullres"],
                             configuration="3d_cascade_fullres", folds=[0], device="cpu")
    prev = tmp_path / "oc" / "segs_from_prev_stage_3d_lowres" / "case0.nii.gz"
    assert prev.exists()
    want = jep.predict_folder(in_dir, tmp_path / "rc", model_dir=dirs["3d_cascade_fullres"],
                              configuration="3d_cascade_fullres", folds=[0])
    assert _agree(_seg(prev), _seg(tmp_path / "rc/segs_from_prev_stage_3d_lowres/case0.nii.gz")
                  ) > 0.995
    casc = _seg(got[0])
    assert _agree(casc, _seg(want[0])) > 0.995
    direct = tep.predict_folder(in_dir, tmp_path / "of", model_dir=dirs["3d_fullres"],
                                folds=[0], device="cpu")
    assert casc.shape == _seg(direct[0]).shape == vol.shape
    assert np.any(casc != _seg(direct[0]))
    shutil.rmtree(dirs["3d_lowres"])
    with pytest.raises(FileNotFoundError, match="sibling"):
        tep.predict_folder(in_dir, tmp_path / "ox", model_dir=dirs["3d_cascade_fullres"],
                           configuration="3d_cascade_fullres", folds=[0], device="cpu")


def test_2d_predictor_slice_stack_matches_reference():
    """tests/test_2d.py's slice stack: native grid (fused path) and an
    in-plane resample with z untouched, each as the reference's."""
    import jax

    from boa_tpu.models.unet import init_unet
    from boa_tpu.plans import plans as jplans

    def two_d(mp):
        conf = mp.plans["configurations"]["3d_fullres"]
        conf["patch_size"], conf["spacing"] = [16, 16], [2.0, 2.0]
        kw = conf["architecture"]["arch_kwargs"]
        kw["kernel_sizes"], kw["strides"] = [[3, 3]] * 2, [[1, 1], [2, 2]]
        mp.__post_init__()
        return mp

    kw = dict(num_classes=3, patch_size=(16, 16, 16), spacing=(2.0, 2.0, 2.0),
              features=(4, 8))
    mj, mt = two_d(jplans.synthetic_plans(**kw)), two_d(synthetic_plans(**kw))
    params = init_unet(jax.random.PRNGKey(0), mj.arch_config())
    ref = jpred.Predictor(plans=mj, fold_params=[params], compute_dtype="float32")
    got = tpred.Predictor(plans=mt, fold_params=[jax.tree.map(np.asarray, params)],
                          compute_dtype="float32", device="cpu")
    assert got.two_d and got.cfg.two_d
    vol = np.random.default_rng(0).normal(80, 40, (20, 20, 7)).astype(np.float32)
    for spacing in ((2.0, 2.0, 5.0), (3.0, 3.0, 5.0)):
        seg = got.predict(vol, spacing)
        assert seg.shape == vol.shape and seg.dtype == np.uint8
        assert _agree(seg, ref.predict(vol, spacing)) > 0.995
    assert got.n_tiles == 9  # 30x30 in-plane: 3 x 3 tiles of 16^2 at step 0.5, all of z
    g = got._gauss((16, 16, 7))
    assert g.shape == (16, 16, 7) and g.stride()[2] == 0
    torch.testing.assert_close(g[..., 3], g[..., 0], rtol=0, atol=0)


def test_fingerprint_matches_reference():
    rng = np.random.default_rng(0)
    cases = []
    for i in range(3):
        data = np.zeros((24, 20, 18), np.float32)
        data[2:20, 3:17, 1:15] = rng.normal(100, 50, (18, 14, 14))
        seg = (data > 120).astype(np.uint8) if i else None
        cases.append((data, seg, (1.5, 1.5, 3.0 + i)))
    data4 = np.stack([cases[0][0], np.roll(cases[0][0], 2, axis=0)])
    assert tfp.pp.nonzero_bbox(data4) == jfp.pp.nonzero_bbox(data4)
    assert tfp.pp.nonzero_bbox(np.zeros((4, 5, 6))) == ((0, 4), (0, 5), (0, 6))
    got, want = tfp.extract_fingerprint(cases), jfp.extract_fingerprint(cases)
    assert got["spacings"] == want["spacings"]
    assert got["shapes_after_crop"] == want["shapes_after_crop"]
    a = got["foreground_intensity_properties_per_channel"]["0"]
    b = want["foreground_intensity_properties_per_channel"]["0"]
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-6)


def _refs_preds(tmp_path, rng):
    ref_dir, pred_dir = tmp_path / "refs", tmp_path / "preds"
    ref_dir.mkdir()
    pred_dir.mkdir()
    affine = np.diag([1.5, 1.5, 3.0, 1.0])
    for cid in ("c1", "c2", "c3"):
        ref = np.zeros((16, 14, 10), np.uint8)
        ref[4:10, 4:10, 2:8] = 1
        ref[11:14, 2:6, 1:4] = 2
        pred = ref.copy()
        flip = rng.random(ref.shape) < 0.05
        pred[flip] = rng.integers(0, 3, flip.sum())
        nifti.save(nifti.NiftiImage(data=ref, affine=affine), ref_dir / f"{cid}.nii.gz")
        nifti.save(nifti.NiftiImage(data=pred, affine=affine), pred_dir / f"{cid}.nii.gz")
    return ref_dir, pred_dir


def _close_json(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close_json(a[k], b[k])
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    elif isinstance(a, (int, float)):
        assert a == pytest.approx(b, rel=1e-6, abs=1e-6)
    else:
        assert a == b


def test_evaluation_matches_reference(tmp_path):
    ref_dir, pred_dir = _refs_preds(tmp_path, np.random.default_rng(1))
    for labels in (None, [1, 2, (1, 2)]):
        _close_json(teval.evaluate_folders(ref_dir, pred_dir, labels=labels),
                    jeval.evaluate_folders(ref_dir, pred_dir, labels=labels))
    r = teval.evaluate_case(_seg(ref_dir / "c1.nii.gz"), _seg(pred_dir / "c1.nii.gz"),
                            [1, 2], ignore_label=2)
    _close_json(r, jeval.evaluate_case(_seg(ref_dir / "c1.nii.gz"),
                                       _seg(pred_dir / "c1.nii.gz"), [1, 2], ignore_label=2))
    teval.main([str(ref_dir), str(pred_dir), "-o", str(tmp_path / "t.json")])
    jeval.main([str(ref_dir), str(pred_dir), "-o", str(tmp_path / "j.json")])
    _close_json(json.loads((tmp_path / "t.json").read_text()),
                json.loads((tmp_path / "j.json").read_text()))
    (pred_dir / "c3.nii.gz").unlink()
    with pytest.raises(FileNotFoundError, match="missing predictions"):
        teval.evaluate_folders(ref_dir, pred_dir)


def test_ensembling_main_matches_reference(tmp_path):
    """tests/test_engine.py's two configurations: nnUNetv2_ensemble with a
    postprocessing plan, through both `main`s; the seg, the ensembled
    probabilities and the evaluation as the reference's."""
    rng = np.random.default_rng(2)
    cfgs = [tmp_path / "cfgA", tmp_path / "cfgB"]
    for d in cfgs:
        d.mkdir()
    for cid in ("c1", "c2"):
        for d, flip in zip(cfgs, (0.9, 0.8)):
            probs = np.zeros((3, 16, 14, 10), np.float16)
            probs[0] = 1.0
            probs[1, 4:10, 4:10, 2:8], probs[0, 4:10, 4:10, 2:8] = flip, 1.0 - flip
            probs[1, 0, 0, 0], probs[0, 0, 0, 0] = 0.95, 0.05
            probs[2] = rng.random((16, 14, 10)).astype(np.float16) * 0.3
            np.savez_compressed(d / f"{cid}.npz", probabilities=probs)
            with open(d / f"{cid}.pkl", "wb") as fh:
                pickle.dump({"spacing": (3.0, 1.5, 1.5)}, fh)
    pp = tmp_path / "pp.json"
    pp.write_text(json.dumps([{"fn": "remove_all_but_largest_component",
                               "kwargs": {"labels_or_regions": [1]}}]))
    args = ["-i", *map(str, cfgs), "--save_npz", "-pp", str(pp)]
    tens.main(args + ["-o", str(tmp_path / "t")])
    jens.main(args + ["-o", str(tmp_path / "j")])
    for cid in ("c1", "c2"):
        a, b = nifti.load(tmp_path / f"t/{cid}.nii.gz"), nifti.load(tmp_path / f"j/{cid}.nii.gz")
        np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
        assert np.allclose(a.affine, b.affine, atol=1e-6)
        np.testing.assert_allclose(np.load(tmp_path / f"t/{cid}.npz")["probabilities"],
                                   np.load(tmp_path / f"j/{cid}.npz")["probabilities"],
                                   rtol=1e-6, atol=1e-6)
    assert _seg(tmp_path / "t/c1.nii.gz")[0, 0, 0] == 0   # the speckle is removed
    probs = [np.load(d / "c1.npz")["probabilities"] for d in cfgs]
    np.testing.assert_allclose(tens.ensemble_probabilities(probs),
                               jens.ensemble_probabilities(probs), rtol=1e-6, atol=1e-6)


def test_postprocessing_and_best_configuration_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    ref_dir, good = _refs_preds(tmp_path, rng)
    bad = tmp_path / "bad"
    bad.mkdir()
    for p in sorted(ref_dir.glob("*.nii.gz")):
        seg = _seg(good / p.name).copy()
        seg[0, 0, 0], seg[15, 13, 9] = 1, 2          # stray speckles
        seg[4:7] = 0                                  # undersegmented
        nifti.save(nifti.NiftiImage(data=seg, affine=np.eye(4)), bad / p.name)
    refs = {p.name[:-7]: _seg(p) for p in sorted(ref_dir.glob("*.nii.gz"))}
    preds = {k: _seg(bad / f"{k}.nii.gz") for k in refs}
    assert tens.determine_postprocessing(refs, preds, [0, 1, 2]) == \
        jens.determine_postprocessing(refs, preds, [0, 1, 2])
    for k, v in preds.items():
        plan = [{"fn": "remove_all_but_largest_component",
                 "kwargs": {"labels_or_regions": [1, 2]}}]
        np.testing.assert_array_equal(tens.apply_postprocessing(v, plan),
                                      jens.apply_postprocessing(v, plan))
    got = tens.find_best_configuration_folders(ref_dir, {"good": good, "bad": bad},
                                               out_file=tmp_path / "best.json")
    want = jens.find_best_configuration_folders(ref_dir, {"good": good, "bad": bad})
    _close_json(json.loads(json.dumps(got, default=str)),
                json.loads(json.dumps(want, default=str)))
    assert got["best_configuration"] == "good" and (tmp_path / "best.json").exists()


def test_predict_main_device_rule_and_cases(tmp_path, monkeypatch):
    """`-device` defaults to the card (RuntimeError without CUDA), `cpu`
    runs on the host, anything else raises; `list_cases` as the reference."""
    create_synthetic_model(tmp_path / "w", 903, "Toy", num_classes=3,
                           patch_size=(16, 16, 16), features=(4, 8))
    in_dir = _cases(tmp_path / "cases", ["a_0000.nii.gz", "a_0001.nii.gz", "s_0001.nii.gz",
                                         "s_0002.nii.gz", "p.nii"])
    assert [(c, [f.name for f in fs]) for c, fs in tep.list_cases(in_dir)] == \
        [(c, [f.name for f in fs]) for c, fs in jep.list_cases(in_dir)]
    monkeypatch.setenv("BOA_WEIGHTS_PATH", str(tmp_path / "w"))
    (in_dir / "a_0000.nii.gz").unlink()
    (in_dir / "a_0001.nii.gz").unlink()
    args = ["-i", str(in_dir), "-o", str(tmp_path / "o"), "-d", "903", "-f", "0",
            "--disable_tta"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tep.main(args)
    with pytest.raises(ValueError, match="unsupported device"):
        tep.main(args + ["-device", "tpu"])
    tep.main(args + ["-device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "o").glob("*.nii.gz")) == \
        ["p.nii.gz", "s_0001.nii.gz", "s_0002.nii.gz"]


@pytest.mark.parametrize("threads", [1, 3])
def test_threaded_npz_reads_as_numpy_savez(tmp_path, monkeypatch, threads):
    """io/npz.py's archive (small blocks: many per member) loads as
    numpy.savez_compressed's does, with valid CRCs; every block of a
    non-empty member was deflated by the pool (zipfile took the private
    `_compressor`), on one thread per core."""
    import os
    import zipfile

    from boa_tpu_torch.io import npz

    monkeypatch.setattr(npz, "BLOCK_BYTES", 4096)
    monkeypatch.setattr(os, "cpu_count", lambda: threads)
    pools, blocks = [], []
    real_pool, real_deflate = npz.ThreadPoolExecutor, npz._deflate

    def pool(n):
        pools.append(n)
        return real_pool(n)

    def deflate(data, level):
        blocks.append(len(data))
        return real_deflate(data, level)
    monkeypatch.setattr(npz, "ThreadPoolExecutor", pool)
    monkeypatch.setattr(npz, "_deflate", deflate)
    rng = np.random.default_rng(8)
    arrays = {"probabilities": (rng.random((3, 17, 19, 23)) ** 6).astype(np.float16),
              "w": np.asfortranarray(rng.normal(size=(5, 7)).astype(np.float32)),
              "s": np.float32(2.5), "e": np.zeros((0, 4), np.int16)}
    npz.savez_compressed(tmp_path / "a.npz", **arrays)
    np.savez_compressed(tmp_path / "b.npz", **arrays)
    assert pools == [threads]
    # each member's header and data pass through the pool: nothing deflated
    # on zipfile's own compressor
    data = sum(a.nbytes for a in arrays.values())
    assert sum(blocks) > data and len(blocks) >= data // 4096
    got, want = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert zipfile.ZipFile(tmp_path / "a.npz").testzip() is None
    with pytest.raises(ValueError, match="object"):
        npz.savez_compressed(tmp_path / "c.npz", o=np.array([{}], dtype=object))
