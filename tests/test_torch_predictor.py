"""The port's general predictor path against the reference (boa_tpu), same
inputs made with numpy, on the CPU: weight-normalized sliding-window logits
(float32 and float16 accumulators, bucket padding), the predictor's own
resample (isotropic and separate-z), probabilities, region plans, cascade
inputs, the one-hot seg resample and the host ops of the crop cascade.

Bars from the reference's own tests: logits at rtol = atol = 2e-3 with
argmax > 0.999, float16 within 2 % of the scale on the interior, bucketed
against padded at 1e-4 (tests/test_predictor.py); labels > 0.995
(tests/test_predictor.py, tests/test_cascade.py); the seg resample >= 0.999
(ties may differ); host ops bit-identical.
"""

import numpy as np
import pytest
import torch

import jax

from boa_tpu.inference.predictor import Predictor as JPredictor
from boa_tpu.models.unet import init_unet
from boa_tpu.ops import cropping as jcrop
from boa_tpu.ops import morphology as jmorph
from boa_tpu.ops import postprocessing as jpost
from boa_tpu.ops import resample as jrs
from boa_tpu.io.nifti import NiftiImage as JImage
from boa_tpu.plans.plans import ModelPlans as JPlans
from boa_tpu.plans.plans import synthetic_plans as jplans
from boa_tpu_torch.inference import predictor as tpred
from boa_tpu_torch.inference.predictor import Predictor
from boa_tpu_torch.io.nifti import NiftiImage
from boa_tpu_torch.ops import cropping as tcrop
from boa_tpu_torch.ops import morphology as tmorph
from boa_tpu_torch.ops import postprocessing as tpost
from boa_tpu_torch.ops import resample as trs
from boa_tpu_torch.plans.plans import ModelPlans
from boa_tpu_torch.plans.plans import synthetic_plans

KW = dict(num_classes=4, patch_size=(16, 16, 16), spacing=(3.0, 3.0, 3.0),
          features=(8, 16, 32))


def _pair(plans_j, plans_t, n_folds=1, seed=0, **kw):
    """(reference predictor, port predictor) on the same random weights."""
    params = [init_unet(jax.random.PRNGKey(seed + f), plans_j.arch_config())
              for f in range(n_folds)]
    ref = JPredictor(plans=plans_j, fold_params=params, compute_dtype="float32", **kw)
    got = Predictor(plans=plans_t, fold_params=[jax.tree.map(np.asarray, p) for p in params],
                    compute_dtype="float32", device="cpu", **kw)
    return ref, got


def _ct(shape, margin, seed):
    """A CT-like volume with zero margins (exercises crop to nonzero)."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    inner = tuple(slice(margin, n - margin) for n in shape)
    vol[inner] = rng.normal(size=tuple(n - 2 * margin for n in shape)) * 300 + 50
    return vol


def test_predict_logits_matches_reference():
    ref, got = _pair(jplans(**KW), synthetic_plans(**KW), n_folds=2)
    vol = np.random.default_rng(0).normal(size=(1, 24, 20, 18)).astype(np.float32)
    want = np.asarray(ref.predict_logits(vol))
    have = got.predict_logits(vol).numpy()
    assert have.shape == want.shape == (4, 24, 20, 18)
    np.testing.assert_allclose(have, want, rtol=2e-3, atol=2e-3)
    assert (have.argmax(0) == want.argmax(0)).mean() > 0.999
    assert got.n_tiles == 8


def test_fp16_accumulator_and_bucket():
    pj, pt = jplans(**KW), synthetic_plans(**KW)
    ref16, p16 = _pair(pj, pt, accum_dtype="float16")
    _, p32 = _pair(pj, pt, accum_dtype="float32")
    vol = np.random.default_rng(1).normal(size=(1, 24, 20, 18)).astype(np.float32)
    l32 = p32.predict_logits(vol).numpy()
    l16 = p16.predict_logits(vol).float().numpy()
    assert p16.predict_logits(vol).dtype == torch.float16
    assert (p16.accum_used, p32.accum_used) == (torch.float16, torch.float32)
    # tile-corner voxels carry float16-subnormal weights that underflow, in
    # the reference too: compare the interior
    c = (slice(None), slice(2, -2), slice(2, -2), slice(2, -2))
    scale = np.abs(l32[c]).max() + 1e-6
    assert np.abs(l32[c] - l16[c]).max() / scale < 0.02
    assert (l32[c].argmax(0) == l16[c].argmax(0)).mean() > 0.999
    want16 = np.asarray(ref16.predict_logits(vol), np.float32)
    assert np.abs(want16[c] - l16[c]).max() / scale < 0.02

    # bucketing: the centred zero pad to the bucket shape, then the crop
    _, pb = _pair(pj, pt, accum_dtype="float32", bucket=16)
    vol = np.random.default_rng(2).normal(size=(1, 21, 19, 17)).astype(np.float32)
    lb = pb.predict_logits(vol).numpy()
    assert lb.shape[1:] == (21, 19, 17)
    pads = [(d // 2, d - d // 2) for d in (32 - 21, 32 - 19, 32 - 17)]
    l0p = p32.predict_logits(np.pad(vol, [(0, 0)] + pads)).numpy()
    crop = tuple(slice(a, a + n) for (a, _), n in zip(pads, (21, 19, 17)))
    np.testing.assert_allclose(lb, l0p[(slice(None), *crop)], rtol=1e-4, atol=1e-4)
    # the fused path pads to the bucket too
    seg = pb.predict(vol[0] * 300 + 50, (3.0, 3.0, 3.0))
    assert seg.shape == (21, 19, 17) and pb.n_tiles == 27  # 3 per axis of 32
    assert pb.accum_used == torch.float32


@pytest.mark.parametrize("spacing", [(2.0, 2.0, 2.0), (2.0, 2.0, 7.0)])
def test_general_path_matches_reference(spacing):
    """Crop -> normalize -> resample (separate z at (2, 2, 7)) -> logits ->
    order-1 back-resample + class-chunked argmax -> bbox."""
    ref, got = _pair(jplans(**KW), synthetic_plans(**KW))
    vol = _ct((40, 36, 30), 4, 3)
    want = ref.predict(vol, spacing)
    have = got.predict(vol, spacing)
    assert have.shape == want.shape == vol.shape and have.dtype == want.dtype
    assert (have == want).mean() > 0.995
    assert len(np.unique(want)) > 1
    sep = tpred.determine_separate_z(np.array(spacing), np.array([3.0, 3.0, 3.0]))
    assert sep == ((True, 2) if spacing[2] == 7.0 else (False, None))


def test_return_probabilities_matches_reference():
    ref, got = _pair(jplans(**KW), synthetic_plans(**KW))
    vol = _ct((30, 28, 26), 3, 4)
    seg_w, probs_w = ref.predict(vol, (2.0, 2.0, 2.0), return_probabilities=True)
    seg_h, probs_h = got.predict(vol, (2.0, 2.0, 2.0), return_probabilities=True)
    assert probs_h.dtype == np.float16 and probs_h.shape == probs_w.shape == (4,) + vol.shape
    assert (seg_h == seg_w).mean() > 0.995
    np.testing.assert_allclose(probs_h.astype(np.float32), probs_w.astype(np.float32),
                               atol=2e-3)
    # the bbox margin holds zero probabilities, as in the reference
    assert not probs_h[:, 0].any()


def test_region_plans_match_reference():
    """Sigmoid heads painted in regions_class_order (later regions win)."""
    kw = dict(num_classes=3, patch_size=(16, 16, 16), spacing=(1.0, 1.0, 1.0),
              features=(4, 8))
    pj, pt = jplans(**kw), synthetic_plans(**kw)
    for p in (pj, pt):
        p.dataset["labels"] = {"background": 0, "whole": [1, 2], "core": [2]}
        p.dataset["regions_class_order"] = [1, 2]
    assert pt.has_regions and pt.num_segmentation_heads == 2
    assert pt.foreground_labels == pj.foreground_labels == [1, 2]
    ref, got = _pair(pj, pt)
    vol = np.random.default_rng(5).normal(size=(20, 18, 16)).astype(np.float32) * 200 + 40
    want, have = ref.predict(vol, (1.0, 1.0, 1.0)), got.predict(vol, (1.0, 1.0, 1.0))
    assert set(np.unique(have)) <= {0, 1, 2}
    assert (have == want).mean() > 0.995
    # painting order on the port's own logits: wherever core fires, label 2
    props = [pt.intensity_properties]
    logits = got.predict_logits(tpred._normalize(torch.from_numpy(vol)[None], props,
                                                 ("CTNormalization",))).numpy()
    core = logits[1] > 0
    assert core.any() and (have[core] == 2).all()
    assert ((have == 1) == ((logits[0] > 0) & ~core)).all()
    # probabilities are the sigmoid of each head
    _, probs = got.predict(vol, (1.0, 1.0, 1.0), return_probabilities=True)
    np.testing.assert_allclose(probs.astype(np.float32), 1 / (1 + np.exp(-logits)),
                               atol=2e-3)


def _cascade_pair():
    mp = synthetic_plans(num_classes=3, patch_size=(8, 8, 8),
                         spacing=(2.0, 2.0, 2.0), features=(4, 8))
    plans = mp.plans
    low = dict(plans["configurations"]["3d_fullres"])
    low["spacing"] = [4.0, 4.0, 4.0]
    low["next_stage"] = "3d_cascade_fullres"
    plans["configurations"]["3d_lowres"] = low
    plans["configurations"]["3d_cascade_fullres"] = {
        "inherits_from": "3d_fullres", "previous_stage": "3d_lowres"}
    pt = ModelPlans(plans=plans, dataset=mp.dataset,
                    configuration_name="3d_cascade_fullres")
    pj = JPlans(plans=plans, dataset=mp.dataset, configuration_name="3d_cascade_fullres")
    return pj, pt


def test_cascade_input_matches_reference():
    pj, pt = _cascade_pair()
    assert pt.previous_stage == "3d_lowres" and pt.foreground_labels == [1, 2]
    assert pt.num_input_channels == pj.num_input_channels == 3
    ref, got = _pair(pj, pt)
    rng = np.random.default_rng(6)
    vol = rng.normal(60.0, 30.0, (20, 20, 20)).astype(np.float32)
    seg = np.zeros((20, 20, 20), np.int8)
    seg[5:12, 5:12, 5:12] = 1
    seg[13:18, 13:18, 13:18] = 2
    vol[seg == 1] += 90.0
    vol[seg == 2] -= 110.0
    with pytest.raises(ValueError, match="cascade"):
        got.predict(vol, (2.0, 2.0, 2.0))
    with pytest.raises(ValueError, match="shape"):
        got.predict(vol, (2.0, 2.0, 2.0), prev_seg_xyz=np.zeros((4, 4, 4), np.uint8))
    for spacing in ((2.0, 2.0, 2.0), (3.0, 3.0, 3.0)):  # the second resamples
        want = ref.predict(vol, spacing, prev_seg_xyz=seg)
        have = got.predict(vol, spacing, prev_seg_xyz=seg)
        assert have.shape == vol.shape
        assert (have == want).mean() > 0.995
    other = got.predict(vol, (2.0, 2.0, 2.0), prev_seg_xyz=np.zeros_like(seg))
    assert not np.array_equal(other, got.predict(vol, (2.0, 2.0, 2.0), prev_seg_xyz=seg))


@pytest.mark.parametrize("convention,shape,new_shape,windows", [
    ("zoom", (19, 17, 13), (32, 29, 22), None),
    ("zoom", (24, 20, 16), (13, 11, 9), ((30, 16, 3, 2), None, (20, 11, 2, 1))),
    ("resize", (14, 11, 9), (21, 7, 13), None),
])
def test_resample_seg_onehot_matches_reference(convention, shape, new_shape, windows):
    rng = np.random.default_rng(7)
    # blocky labels: 2-voxel cubes of 11 classes (two class chunks of the port)
    seg = np.kron(rng.integers(0, 11, tuple(-(-n // 2) for n in shape)),
                  np.ones((2, 2, 2), np.int64))[:shape[0], :shape[1], :shape[2]]
    seg = seg.astype(np.uint8)
    want = np.asarray(jrs.resample_seg_onehot(seg, new_shape, 11, order=1,
                                              convention=convention, windows=windows))
    have = trs.resample_seg_onehot(torch.from_numpy(seg), new_shape, 11, order=1,
                                   convention=convention, windows=windows).numpy()
    assert have.dtype == np.uint8 and have.shape == want.shape
    assert (have == want).mean() >= 0.999


def test_crop_cascade_host_ops_bit_identical():
    rng = np.random.default_rng(8)
    data = rng.integers(-1000, 1000, (30, 28, 26)).astype(np.int16)
    affine = np.array([[-0.9, 0, 0, 100], [0, 0.8, 0, -80], [0, 0, 2.0, 30],
                       [0, 0, 0, 1.0]])
    mask = np.zeros(data.shape, np.uint8)
    mask[8:15, 10:22, 5:9] = 1
    for addon_mm in ((0, 0, 0), (3, 3, 3), (20, 20, 20)):
        cj, bj = jcrop.crop_to_mask(JImage(data=data, affine=affine),
                                    JImage(data=mask, affine=affine),
                                    addon_mm=addon_mm, dtype=np.int32)
        ct, bt = tcrop.crop_to_mask(NiftiImage(data=data, affine=affine),
                                    NiftiImage(data=mask, affine=affine),
                                    addon_mm=addon_mm, dtype=np.int32)
        assert bt == bj
        np.testing.assert_array_equal(ct.data, cj.data)
        assert ct.data.dtype == cj.data.dtype
        np.testing.assert_array_equal(ct.affine, cj.affine)
        uj = jcrop.undo_crop(cj, JImage(data=data, affine=affine), bj)
        ut = tcrop.undo_crop(ct, NiftiImage(data=data, affine=affine), bt)
        np.testing.assert_array_equal(ut.data, uj.data)
        np.testing.assert_array_equal(ut.affine, uj.affine)
    empty = np.zeros((5, 6, 7), np.uint8)
    assert tcrop.get_bbox_from_mask(empty) == jcrop.get_bbox_from_mask(empty)

    blobs = (rng.random((24, 22, 20)) < 0.02).astype(np.uint8)
    for it in (1, 2, 3):
        np.testing.assert_array_equal(tmorph.binary_dilation_cross(blobs, it),
                                      jmorph.binary_dilation_cross(blobs, it))
    seg = rng.integers(0, 8, blobs.shape).astype(np.uint8)
    np.testing.assert_array_equal(tpost.remove_outside_of_mask(seg, blobs, addon=2),
                                  jpost.remove_outside_of_mask(seg, blobs, addon=2))
    for task in ("kidney_cysts", "face_mr", "appendicular_bones", "liver_vessels"):
        seg = rng.integers(0, 30, (10, 9, 8)).astype(np.uint8)
        np.testing.assert_array_equal(tpost.remove_auxiliary_labels(seg, task),
                                      jpost.remove_auxiliary_labels(seg, task))
    sm = (rng.random((16, 16, 16)) < 0.3).astype(np.uint8)
    np.testing.assert_array_equal(tpost.remove_small_blobs(sm, (2, 1e10)),
                                  jpost.remove_small_blobs(sm, (2, 1e10)))
    np.testing.assert_array_equal(tpost.keep_largest_blob(sm), jpost.keep_largest_blob(sm))
