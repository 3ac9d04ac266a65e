"""The port's radiomics (boa_tpu_torch/measure/radiomics.py) against the
reference's (boa_tpu/measure/radiomics.py) on a seeded 48x40x32 CT and
label volume, on the CPU: the histogram branch (an int16 CT inside
[-1024, 3071], the port's int64 `torch.bincount` histogram against the
reference's XLA segment sum) and the exact direct branch (a CT with a
3500 HU voxel, a float32 CT). Bars: the voxel counts equal, every other
feature within 1e-9 relative."""

import json

import numpy as np
import pytest
import torch

from boa_tpu.io import nifti as jn
from boa_tpu.measure import radiomics as jr
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.measure import radiomics as tr

LABELS = {0: "background", 1: "liver", 2: "spleen", 3: "aorta", 5: "kidney_left",
          7: "absent"}


def _study(seed=0, shape=(48, 40, 32)):
    rng = np.random.default_rng(seed)
    ct = rng.integers(-300, 600, shape).astype(np.int16)
    ct[:, :, :4] = -1000
    seg = np.zeros(shape, np.uint8)
    seg[6:30, 5:25, 4:20] = 1
    seg[28:44, 22:36, 10:28] = 2
    seg[20:24, 20:24, :] = 3
    seg[rng.random(shape) > 0.995] = 5   # speckle: many tiny components
    ct[seg == 3] += 200
    return ct, seg


def _close(got, want, path=""):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, bool) or path.endswith("/voxels"):
        assert got == want, path
    else:
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), path


@pytest.mark.parametrize("variant", ["int16", "int16_implant", "float32", "uint8_labels16"])
def test_get_radiomics_features_equal(variant):
    ct, seg = _study()
    if variant == "int16_implant":
        ct[10, 10, 10] = 3500   # outside the histogram: the direct branch
    elif variant == "float32":
        ct = ct.astype(np.float32) + 0.25
    elif variant == "uint8_labels16":
        seg = seg.astype(np.uint16)
    spacing = (1.5, 1.2, 3.0)
    want = jr.get_radiomics_features(ct, seg, spacing, LABELS)
    got = tr.get_radiomics_features(ct, seg, spacing, LABELS, device="cpu")
    _close(got, want)
    assert got["absent"]["present"] is False and got["liver"]["present"] is True
    assert got["liver"]["shape_VoxelVolume"] > 0


@pytest.mark.parametrize("with_shape", [False, True])
def test_spans_and_shape_switch(with_shape):
    ct, seg = _study(1)
    spans = {}
    got = tr.get_radiomics_features(ct, seg, (1.0, 1.0, 1.0), LABELS, with_shape=with_shape,
                                    device="cpu", spans=spans)
    want = jr.get_radiomics_features(ct, seg, (1.0, 1.0, 1.0), LABELS, with_shape=with_shape)
    _close(got, want)
    assert set(spans) == {"radiomics_histogram"} | ({"radiomics_shape"} if with_shape
                                                    else set())


def test_first_order_from_histogram_equals_direct():
    """Within the port: the histogram branch's first-order features equal the
    direct computation on the same integer values."""
    ct, seg = _study(2)
    hist = tr.get_radiomics_features(ct, seg, (1.0, 1.0, 1.0), LABELS, with_shape=False,
                                     device="cpu")
    for lb, name in LABELS.items():
        if lb == 0:
            continue
        _close(hist[name], tr.first_order_features(ct[seg == lb], 0.001), name)


def test_entire_dir_equal(tmp_path):
    """`get_radiomics_features_for_entire_dir` over a folder of label files
    (a labelled multilabel file, an unlabelled mask, a file on another grid
    and image.nii.gz, which are skipped): the same JSON."""
    ct, seg = _study(3)
    aff = np.diag([1.5, 1.5, 3.0, 1.0])
    (tmp_path / "in").mkdir()
    tn.save(tn.NiftiImage(data=ct, affine=aff), tmp_path / "in" / "ct.nii.gz")
    lab = tn.NiftiImage(data=seg, affine=aff)
    lab.set_label_map(LABELS)
    tn.save(lab, tmp_path / "total.nii.gz")
    tn.save(tn.NiftiImage(data=(seg == 2).astype(np.uint8), affine=aff),
            tmp_path / "mask.nii.gz")
    tn.save(tn.NiftiImage(data=seg[:8], affine=aff), tmp_path / "other_grid.nii.gz")
    tn.save(tn.NiftiImage(data=ct, affine=aff), tmp_path / "image.nii.gz")
    want = jr.get_radiomics_features_for_entire_dir(tmp_path / "in" / "ct.nii.gz", tmp_path,
                                                    tmp_path / "ref.json")
    got = tr.get_radiomics_features_for_entire_dir(tmp_path / "in" / "ct.nii.gz", tmp_path,
                                                   tmp_path / "port.json", device="cpu")
    assert sorted(got) == ["mask", "total"]
    _close(got, want)
    _close(json.loads((tmp_path / "port.json").read_text()),
           json.loads((tmp_path / "ref.json").read_text()))
    assert jn.load(tmp_path / "total.nii.gz").get_label_map() == LABELS


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ct, seg = _study()
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.get_radiomics_features(ct, seg, (1.0, 1.0, 1.0), LABELS)


def test_entire_dir_empty_unlabelled_mask_raises_as_reference(tmp_path):
    """An all-zero mask without a label map in the folder (the CLI's
    ct_pfav.nii.gz when no lung voxel holds fat) leaves an empty label map:
    both packages raise ValueError (ROADMAP Queue 3, a fault of the
    reference that the port keeps)."""
    ct, seg = _study(4)
    aff = np.diag([1.5, 1.5, 3.0, 1.0])
    (tmp_path / "in").mkdir()
    tn.save(tn.NiftiImage(data=ct, affine=aff), tmp_path / "in" / "ct.nii.gz")
    tn.save(tn.NiftiImage(data=np.zeros(seg.shape, np.uint8), affine=aff),
            tmp_path / "ct_pfav.nii.gz")
    with pytest.raises(ValueError):
        jr.get_radiomics_features_for_entire_dir(tmp_path / "in" / "ct.nii.gz", tmp_path,
                                                 tmp_path / "ref.json")
    with pytest.raises(ValueError):
        tr.get_radiomics_features_for_entire_dir(tmp_path / "in" / "ct.nii.gz", tmp_path,
                                                 tmp_path / "port.json", device="cpu")
