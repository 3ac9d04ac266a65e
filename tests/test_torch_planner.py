"""The port's dataset side against the reference on the CPU: the planner's
plans equal (every configuration, the ResEnc presets, lowres + cascade,
2d, anisotropic spacing), `plan_and_preprocess`'s plans and fingerprint
equal and its case store within 2e-4 on the data (`tests/test_resample.py`'s
bar) and >= 0.999 on the labels, the dataset conversion's files byte-equal,
and the device rule of `plan_and_preprocess`."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from boa_tpu.engine import dataset_conversion as rdc
from boa_tpu.engine import planner as rpl
from boa_tpu.io import nifti as rnifti
from boa_tpu_torch.engine import dataset_conversion as pdc
from boa_tpu_torch.engine import planner as ppl


def _fp(spacings, shapes):
    return {"spacings": [list(s) for s in spacings],
            "shapes_after_crop": [list(s) for s in shapes],
            "foreground_intensity_properties_per_channel": {
                "0": {"max": 1500.0, "mean": 100.0, "median": 80.0, "min": -1000.0,
                      "percentile_00_5": -900.0, "percentile_99_5": 1200.0,
                      "std": 300.0}}}


FINGERPRINTS = {
    "ct_1_5mm": _fp([[1.5, 1.5, 1.5]] * 5, [[300, 260, 400], [280, 250, 380],
                                              [320, 270, 420], [300, 240, 350],
                                              [310, 260, 390]]),
    "aniso": _fp([[0.8, 0.8, 5.0]] * 4 + [[0.7, 0.7, 4.0]], [[512, 512, 40]] * 3
                 + [[480, 480, 36], [512, 512, 60]]),
    "whole_body": _fp([[0.8, 0.8, 1.0]] * 10, [[512, 512, 900]] * 10),
    "small": _fp([[2.0, 2.0, 2.0]] * 3, [[40, 36, 30], [42, 38, 30], [40, 40, 28]]),
}


@pytest.mark.parametrize("name", sorted(FINGERPRINTS))
@pytest.mark.parametrize("preset", [None, "resenc_m", "resenc_l"])
def test_plan_experiment_equal_to_reference(name, preset, tmp_path):
    fp = FINGERPRINTS[name]
    for n_cls in (3, 118):
        got = ppl.plan_experiment(fp, n_cls, out_file=tmp_path / "a.json", preset=preset)
        want = rpl.plan_experiment(fp, n_cls, out_file=tmp_path / "b.json", preset=preset)
        assert got == want
        assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def test_planner_helpers_equal_to_reference():
    r = np.random.default_rng(0)
    for _ in range(20):
        sp = r.uniform(0.5, 6.0, 3)
        patch = r.integers(16, 300, 3)
        assert ppl.pool_and_conv_props(sp, patch) == rpl.pool_and_conv_props(sp, patch)
        spacings = r.uniform(0.5, 5.0, (6, 3))
        sizes = r.integers(20, 600, (6, 3))
        np.testing.assert_array_equal(ppl.determine_target_spacing(spacings, sizes),
                                      rpl.determine_target_spacing(spacings, sizes))
    assert ppl.estimate_activation_elements((128, 128, 128), (32, 64, 128, 256, 320, 320),
                                            [[1, 1, 1]] + [[2, 2, 2]] * 5, 118) == \
        rpl.estimate_activation_elements((128, 128, 128), (32, 64, 128, 256, 320, 320),
                                         [[1, 1, 1]] + [[2, 2, 2]] * 5, 118)
    fp = FINGERPRINTS["aniso"]
    assert ppl.plan_configuration_2d(fp, 5) == rpl.plan_configuration_2d(fp, 5)
    assert ppl.plan_configuration(fp, 5, hbm_target_gb=16) == \
        rpl.plan_configuration(fp, 5, hbm_target_gb=16)


def _raw_dataset(root: Path, n=3, two_channels=False):
    ds = root / "Dataset001_Toy"
    (ds / "imagesTr").mkdir(parents=True)
    (ds / "labelsTr").mkdir()
    (ds / "dataset.json").write_text(json.dumps({
        "channel_names": {"0": "CT"}, "labels": {"background": 0, "a": 1, "b": 2},
        "numTraining": n, "file_ending": ".nii.gz"}))
    r = np.random.default_rng(1)
    for k in range(n):
        shape = (30 + 2 * k, 28, 20 + k)
        data = np.zeros(shape, np.int16)
        data[2:-2, 3:-3, 1:-1] = r.integers(-300, 600, (shape[0] - 4, shape[1] - 6,
                                                         shape[2] - 2))
        seg = np.zeros(shape, np.uint8)
        seg[6:14, 6:14, 4:12] = 1
        seg[16:24, 10:20, 8:16] = 2
        aff = np.diag([1.2 + 0.1 * k, 1.1, 2.0 + 0.3 * k, 1.0])
        rnifti.save(rnifti.NiftiImage(data=data, affine=aff),
                    ds / "imagesTr" / f"case{k}_0000.nii.gz")
        rnifti.save(rnifti.NiftiImage(data=seg, affine=aff), ds / "labelsTr" / f"case{k}.nii.gz")
    return ds


def test_plan_and_preprocess_matches_reference(tmp_path):
    from boa_tpu.engine.plan_and_preprocess import plan_and_preprocess as ref_pp
    from boa_tpu_torch.engine.plan_and_preprocess import plan_and_preprocess

    ds = _raw_dataset(tmp_path)
    got = plan_and_preprocess(ds, tmp_path / "mine", device="cpu")
    want = ref_pp(ds, tmp_path / "ref")
    assert got == want
    for name in ("plans.json", "fingerprint.json"):
        assert (tmp_path / "mine" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    mine, ref = tmp_path / "mine" / "cases", tmp_path / "ref" / "cases"
    assert sorted(p.name for p in mine.iterdir()) == sorted(p.name for p in ref.iterdir())
    resampled = 0
    for p in sorted(mine.glob("*_data.npy")):
        a, b = np.load(p), np.load(ref / p.name)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
        sa, sb = np.load(str(p).replace("_data", "_seg")), np.load(ref / p.name.replace(
            "_data", "_seg"))
        assert sa.shape == sb.shape and (sa == sb).mean() >= 0.999
        props = (p.parent / p.name.replace("_data.npy", "_props.json")).read_text()
        assert props == (ref / p.name.replace("_data.npy", "_props.json")).read_text()
        resampled += a.shape[1:] != (30, 28, 20)
    assert resampled   # the cases' spacings differ from the plan's: the resample ran


def test_plan_and_preprocess_device_rule(tmp_path, monkeypatch):
    from boa_tpu_torch.engine.plan_and_preprocess import main

    ds = _raw_dataset(tmp_path, n=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(ds), str(tmp_path / "o")])
    main([str(ds), str(tmp_path / "o"), "-d", "cpu", "-c", "3d_fullres", "3d_lowres"])
    assert (tmp_path / "o" / "cases").is_dir()
    assert not (tmp_path / "o" / "cases_3d_lowres").exists()   # not planned here


# ---------------------------------------------------------------- conversion
def _tree_bytes(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_generate_dataset_json_byte_equal(tmp_path):
    args = ({0: "CT", 1: "PET"}, {"background": 0, "whole": (1, 2), "core": 2}, 7, ".nii.gz")
    kw = dict(regions_class_order=(1, 2), dataset_name="Demo", description="x",
              license="CC", extra_key=[1, 2])
    assert pdc.generate_dataset_json(tmp_path / "a", *args, **kw) == \
        rdc.generate_dataset_json(tmp_path / "b", *args, **kw)
    assert (tmp_path / "a" / "dataset.json").read_bytes() == \
        (tmp_path / "b" / "dataset.json").read_bytes()
    with pytest.raises(ValueError, match="regions_class_order"):
        pdc.generate_dataset_json(tmp_path / "c", *args)


def _msd_task(root: Path) -> Path:
    src = root / "Task05_Prostate"
    r = np.random.default_rng(2)
    for cid in ("prostate_00", "prostate_01"):
        (src / "imagesTr").mkdir(parents=True, exist_ok=True)
        (src / "labelsTr").mkdir(parents=True, exist_ok=True)
        data = r.integers(-100, 200, size=(6, 5, 4, 2)).astype(np.int16)
        aff = np.diag([0.6, 0.6, 3.6, 1.0])
        rnifti.save(rnifti.NiftiImage(data=data, affine=aff),
                    src / "imagesTr" / f"{cid}.nii.gz")
        seg = np.zeros((6, 5, 4), np.uint8)
        seg[2:4, 2:4, 1:3] = 1
        rnifti.save(rnifti.NiftiImage(data=seg, affine=aff), src / "labelsTr" / f"{cid}.nii.gz")
    (src / "imagesTs").mkdir()
    rnifti.save(rnifti.NiftiImage(data=r.integers(0, 9, (6, 5, 4)).astype(np.int16),
                                  affine=np.eye(4)), src / "imagesTs" / "prostate_02.nii.gz")
    (src / "imagesTr" / "._junk.nii.gz").write_bytes(b"not a nifti")
    (src / "dataset.json").write_text(json.dumps({
        "name": "Prostate", "modality": {"0": "T2", "1": "ADC"},
        "labels": {"0": "background", "1": "peripheral zone"},
        "training": [{"image": "./imagesTr/prostate_00.nii.gz"}], "test": []}))
    return src


def test_convert_msd_dataset_byte_equal(tmp_path):
    src = _msd_task(tmp_path)
    a = pdc.convert_msd_dataset(src, raw_root=tmp_path / "a")
    b = rdc.convert_msd_dataset(src, raw_root=tmp_path / "b")
    assert a.name == b.name == "Dataset005_Prostate"
    ta, tb = _tree_bytes(a), _tree_bytes(b)
    assert ta.keys() == tb.keys() and len(ta) == 8
    for k in ta:
        assert ta[k] == tb[k], k
    with pytest.raises(FileExistsError):
        pdc.convert_msd_dataset(src, raw_root=tmp_path / "a")
    assert pdc.convert_msd_dataset(src, 201, raw_root=tmp_path / "a").name == \
        "Dataset201_Prostate"
    pdc.main(["-i", str(src), "-overwrite_id", "202", "--raw-root", str(tmp_path / "a")])
    assert (tmp_path / "a" / "Dataset202_Prostate" / "dataset.json").exists()


def test_split_4d_nifti_byte_equal(tmp_path):
    r = np.random.default_rng(3)
    four = tmp_path / "case_01.nii.gz"
    rnifti.save(rnifti.NiftiImage(data=r.normal(size=(7, 6, 5, 3)).astype(np.float32),
                                  affine=np.diag([0.9, 0.8, 2.5, 1.0])), four)
    outs_a = pdc.split_4d_nifti(four, tmp_path / "a")
    outs_b = rdc.split_4d_nifti(four, tmp_path / "b")
    assert [p.name for p in outs_a] == [p.name for p in outs_b]
    for pa_, pb_ in zip(outs_a, outs_b):
        assert pa_.read_bytes() == pb_.read_bytes()
    bad = tmp_path / "case_02.nii.gz"
    rnifti.save(rnifti.NiftiImage(data=np.zeros((2, 2), np.int16), affine=np.eye(4)), bad)
    with pytest.raises(ValueError):
        pdc.split_4d_nifti(bad, tmp_path / "c")
