"""The port's morphology (boa_tpu_torch/ops/morphology.py) and measurement
engine (boa_tpu_torch/measure/measurements.py) against the reference
(boa_tpu/ops/morphology.py, boa_tpu/measure/measurements.py), same numpy
inputs from a seed, on the CPU.

Bars: every mask and label volume equal; the measurement dicts equal in
every key, None and flag, their histogram-derived numbers equal and the
others (the autochthon reference's mean and std, CNRs) within 1e-6
relative; the ct_pfav mask and file equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boa_tpu.io import nifti as jn
from boa_tpu.measure import measurements as jm
from boa_tpu.ops import morphology as jmorph
from boa_tpu.tasks import class_maps as jcm
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.measure import measurements as tm
from boa_tpu_torch.ops import morphology as tmorph
from boa_tpu_torch.ops import packing

INV = {n: i for i, n in jcm.get_class_map("total").items()}


def _mask(shape=(21, 18, 15), seed=0, p=0.75, block=3, flips=0.03):
    """Blobby random mask: a coarse random field, nearest-upsampled, with a
    share `flips` of voxels flipped."""
    rng = np.random.default_rng(seed)
    coarse = rng.random(tuple(-(-n // block) for n in shape)) < p
    m = np.kron(coarse, np.ones((block,) * 3, bool))[:shape[0], :shape[1], :shape[2]]
    m ^= rng.random(shape) < flips
    return m.astype(np.uint8)


@pytest.mark.parametrize("op", ["erosion_box", "erosion_box_border1", "dilation_box"])
@pytest.mark.parametrize("size", [2, 3, 6])
def test_box_morphology_matches_reference(op, size):
    if op == "dilation_box":
        m = _mask((30, 28, 24), seed=size, p=0.02, block=2, flips=0.0)
    else:
        m = _mask((30, 28, 24), seed=size, p=0.8, block=7)
    want = np.asarray(getattr(jmorph, op)(jnp.asarray(m), size))
    got = getattr(tmorph, op)(torch.from_numpy(m), size)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("iterations", [1, 3])
def test_cross_morphology_matches_reference(iterations):
    m = _mask(seed=10 + iterations, p=0.85)
    for op in ("binary_erosion_cross", "binary_dilation_cross"):
        want = getattr(jmorph, op)(m, iterations=iterations)
        got = getattr(tmorph, op)(m, iterations=iterations)
        assert got.dtype == np.uint8, op
        np.testing.assert_array_equal(got, want, err_msg=op)
    assert tmorph.binary_erosion_cross(m, iterations).sum() > 0


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_median_filter_inplane_matches_reference(dtype):
    vol = (np.random.default_rng(5).normal(size=(13, 11, 4)) * 200).astype(dtype)
    want = np.asarray(jmorph.median_filter_inplane(jnp.asarray(vol), 3))
    got = tmorph.median_filter_inplane(torch.from_numpy(vol), 3)
    assert got.dtype == torch.from_numpy(vol).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    from scipy import ndimage

    np.testing.assert_array_equal(got.numpy(), ndimage.median_filter(vol, size=(3, 3, 1)))


def test_fill_holes_and_mask_transfers():
    m = np.zeros((9, 9, 9), np.uint8)
    m[2:7, 2:7, 2:7] = 1
    m[4, 4, 4] = 0
    np.testing.assert_array_equal(tmorph.binary_fill_holes_host(m),
                                  jmorph.binary_fill_holes_host(m))
    up = packing.upload_mask(m * 7, torch.device("cpu"))
    assert up.dtype == torch.uint8 and int(up.max()) == 1
    np.testing.assert_array_equal(packing.download_mask(up * 3), m)
    wide = torch.from_numpy(m.astype(np.int32) * 300)
    np.testing.assert_array_equal(packing.download_labels_wide(wide), m.astype(np.int32) * 300)


@pytest.fixture(scope="module")
def volume():
    """tests/test_measurements.py's fixture: autochthon with muscle HU,
    aorta, a lung lobe and a small spleen in random HU; plus a second lobe
    with fat HU in part, so the pulmonary fat has voxels."""
    rng = np.random.default_rng(11)
    shape = (48, 44, 40)
    ct = rng.integers(-1000, 1200, size=shape).astype(np.int16)
    seg = np.zeros(shape, np.uint8)
    seg[10:24, 10:24, 10:24] = INV["autochthon_left"]
    seg[26:40, 10:24, 10:24] = INV["autochthon_right"]
    muscle = rng.integers(20, 80, size=shape).astype(np.int16)
    auto_region = np.isin(seg, [INV["autochthon_left"], INV["autochthon_right"]])
    ct[auto_region] = muscle[auto_region]
    seg[10:20, 26:38, 8:20] = INV["aorta"]
    seg[28:40, 26:40, 8:30] = INV["lung_upper_lobe_left"]
    seg[5:9, 5:9, 30:36] = INV["spleen"]
    seg[2:9, 30:42, 24:38] = INV["lung_lower_lobe_right"]
    ct[2:9, 30:42, 24:31] = rng.integers(-200, -39, size=(7, 12, 7))
    return ct, seg


def test_adjusted_label_volume_matches_reference(volume):
    ct, seg = volume
    labels = (INV["aorta"], INV["autochthon_left"], INV["autochthon_right"])
    fat = (False, True, True)
    want = np.asarray(jm._adjusted_label_volume(jnp.asarray(seg), jnp.asarray(ct),
                                                labels, fat))
    got = tm._adjusted_label_volume(torch.from_numpy(seg), torch.from_numpy(ct), labels, fat)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2, 3}


def _close(got, want, path="") -> None:
    """Same keys, flags and Nones; floats within 1e-6 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif want is None or isinstance(want, bool):
        assert got is want, path
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=path)


_EXACT = ("present", "volume_ml", "min_hu", "max_hu", "median_hu",
          "25th_percentile_hu", "75th_percentile_hu")


@pytest.mark.parametrize("cnr_adjustment", [True, False])
@pytest.mark.parametrize("ct_kind", ["int16", "float_host", "int16_device"])
def test_measurements_arrays_match_reference(volume, cnr_adjustment, ct_kind):
    ct, seg = volume
    spacing = (1.0, 1.0, 2.0)
    if ct_kind == "float_host":
        # a non-int16 CT is cast on the host with numpy's semantics
        ct = ct.astype(np.float32) + np.float32(0.6)
    kw = {}
    if ct_kind == "int16_device":
        kw = {"ct_dev": torch.from_numpy(ct), "seg_devs": {"total": torch.from_numpy(seg)}}
    want = jm.compute_measurements_arrays(ct, {"total": seg}, spacing,
                                          cnr_adjustment=cnr_adjustment)
    spans: dict = {}
    got = tm.compute_measurements_arrays(ct, {"total": seg}, spacing,
                                         cnr_adjustment=cnr_adjustment, device="cpu",
                                         spans=spans, **kw)
    _close(got, want)
    for region, m in want["segmentations"]["total"].items():
        for k in _EXACT:
            if k in m:
                assert got["segmentations"]["total"][region][k] == m[k], (region, k)
    assert want["info"]["autochthon_mean"] is not None
    present = [r for r, m in want["segmentations"]["total"].items() if m["present"]]
    assert {"aorta", "spleen", "autochthon", "ct_pfav_lung_lower_lobe_right",
            "ct_pfav_lungs"} <= set(present)
    assert ("cnr_adjusted" in got) == cnr_adjustment
    if cnr_adjustment:
        assert all(got["cnr_adjusted"][r]["present"] for r in got["cnr_adjusted"])
    assert {"total.upload", "total.histogram", "autochthon"} <= set(spans)


def test_pfav_masks_match_reference(volume):
    ct, seg = volume
    want = jm.compute_pfav_mask(ct, seg)
    np.testing.assert_array_equal(tm.compute_pfav_mask(ct, seg), want)
    np.testing.assert_array_equal(
        tm._pfav_mask_device(torch.from_numpy(ct), torch.from_numpy(seg)), want)
    assert want.sum() > 100


@pytest.mark.parametrize("source", ["files", "images"])
def test_compute_measurements_writes_pfav(tmp_path, volume, source):
    """From files on disk (the CT and total.nii.gz) or from images in
    memory; ct_pfav.nii.gz byte-identical to the reference's."""
    ct, seg = volume
    aff = np.diag([-1.0, -1.0, 2.0, 1.0])
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        tn.save(tn.NiftiImage(data=seg, affine=aff), tmp_path / d / "total.nii.gz")
    tn.save(tn.NiftiImage(data=ct, affine=aff), tmp_path / "ct.nii.gz")
    want = jm.compute_measurements(tmp_path / "ct.nii.gz", tmp_path / "j", ["total"], True)
    kw = {}
    if source == "images":
        kw = {"ct_image": tn.load(tmp_path / "ct.nii.gz"),
              "seg_images": {"total": tn.NiftiImage(data=seg, affine=aff)}}
    got = tm.compute_measurements(tmp_path / "ct.nii.gz", tmp_path / "t", ["total"], True,
                                  device="cpu", **kw)
    _close(got, want)
    assert (tmp_path / "t" / "ct_pfav.nii.gz").read_bytes() == \
        (tmp_path / "j" / "ct_pfav.nii.gz").read_bytes()
    np.testing.assert_array_equal(jn.load(tmp_path / "t" / "ct_pfav.nii.gz").data,
                                  jm.compute_pfav_mask(ct, seg))
    assert tm.compute_measurements(tmp_path / "ct.nii.gz", tmp_path / "t", [], True,
                                   device="cpu") == {"segmentations": {}, "info": {}}
