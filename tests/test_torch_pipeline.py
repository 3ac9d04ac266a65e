"""The port's predictor, resampling, host ops and `predict_image` against
the reference (boa_tpu), same inputs made with numpy, on the CPU.

Bars from the reference's own tests: predictor segmentation agreement
> 0.995 (tests/test_predictor.py), resample order 0 bit-identical and
orders 1 / 3 at rtol 2e-4 (tests/test_resample.py), `predict_image` labels
> 0.995 in float32 and > 0.99 in bf16 (where the port runs its row-conv
composite and the reference its default eager forward).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from boa_tpu.inference import pipeline as jpipe
from boa_tpu.inference.predictor import Predictor as JPredictor
from boa_tpu.io import nifti as jnifti
from boa_tpu.models.unet import init_unet
from boa_tpu.ops import cropping as jcrop
from boa_tpu.ops import postprocessing as jpost
from boa_tpu.ops import resample as jrs
from boa_tpu.plans.plans import synthetic_plans as jplans
from boa_tpu.weights import convert as jcv
from boa_tpu.weights.store import ModelStore as JStore
from boa_tpu.weights.store import create_synthetic_model
from boa_tpu_torch.inference import pipeline as tpipe
from boa_tpu_torch.inference.predictor import Predictor
from boa_tpu_torch.io import nifti as tnifti
from boa_tpu_torch.ops import cropping as tcrop
from boa_tpu_torch.ops import postprocessing as tpost
from boa_tpu_torch.ops import resample as trs
from boa_tpu_torch.plans.plans import synthetic_plans
from boa_tpu_torch.weights.store import ModelStore

EXAMPLE_CT = Path(__file__).parent / "data" / "example_ct.nii.gz"


@pytest.mark.parametrize("n_folds,shape", [(1, (34, 30, 27)),
                                           (2, (30, 26, 12))])  # z below the patch
def test_predictor_matches_reference(n_folds, shape):
    kw = dict(num_classes=4, patch_size=(16, 16, 16), spacing=(3.0, 3.0, 3.0),
              features=(8, 16, 32))
    pj, pt = jplans(**kw), synthetic_plans(**kw)
    assert pj.plans == pt.plans and pj.dataset == pt.dataset
    params = [init_unet(jax.random.PRNGKey(10 + f), pj.arch_config())
              for f in range(n_folds)]
    rng = np.random.default_rng(n_folds)
    vol = np.zeros(shape, np.float32)   # zero margins: crop to nonzero
    inner = tuple(slice(2, n - 2) for n in shape)
    vol[inner] = rng.normal(size=tuple(n - 4 for n in shape)) * 300 + 50
    ref = JPredictor(plans=pj, fold_params=params, compute_dtype="float32"
                     ).predict(vol, (3.0, 3.0, 3.0))
    got = Predictor(plans=pt, fold_params=[jax.tree.map(np.asarray, p) for p in params],
                    compute_dtype="float32", device="cpu").predict(vol, (3.0, 3.0, 3.0))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    agree = (got == ref).mean()
    assert agree > 0.995, f"segmentation agreement {agree}"


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("convention,shape,new_shape,windowed", [
    ("zoom", (19, 17, 13), (32, 29, 22), False),
    ("zoom", (24, 20, 16), (13, 11, 9), True),
    ("resize", (14, 11, 9), (21, 7, 13), False),
])
def test_resample_matches_reference(order, convention, shape, new_shape, windowed):
    rng = np.random.default_rng(order)
    vol = (rng.normal(size=shape) * 100).astype(np.float32)
    windows = None
    if windowed:   # a crop of a larger grid, resampled as its exact subgrid
        windows = ((30, 16, 3, 2), None, (20, 11, 2, 1))
    if order == 0:
        ref = np.asarray(jrs.resample_nearest(vol, new_shape, convention=convention,
                                              windows=windows))
        got = trs.resample_nearest(torch.from_numpy(vol), new_shape,
                                   convention=convention, windows=windows).numpy()
        host = trs.resample_nearest_host(vol, new_shape, convention=convention,
                                         windows=windows)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(host, ref)
    else:
        ref = np.asarray(jrs.resample_volume(vol, new_shape, order=order,
                                             convention=convention, windows=windows))
        got = trs.resample_volume(torch.from_numpy(vol), new_shape, order=order,
                                  convention=convention, windows=windows).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)


def test_resample_separate_z_and_shape_math():
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(12, 12, 30)).astype(np.float32)
    ref = np.asarray(jrs.resample_volume(vol, (18, 18, 10), order=3,
                                         convention="resize", separate_z_order=0))
    got = trs.resample_volume(torch.from_numpy(vol), (18, 18, 10), order=3,
                              convention="resize", separate_z_order=0).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    a = jrs.change_spacing_shape((512, 384, 300), (1.5, 1.5, 3.0), (3.0, 3.0, 3.0))
    b = trs.change_spacing_shape((512, 384, 300), (1.5, 1.5, 3.0), (3.0, 3.0, 3.0))
    assert a[0] == b[0] and np.allclose(a[1], b[1]) and np.allclose(a[2], b[2])


def test_host_ops_match_reference():
    img_j = jnifti.load(EXAMPLE_CT)
    data = np.asarray(img_j.data)
    img_t = tnifti.NiftiImage(data=data, affine=img_j.affine)
    cj, ij = jcrop.body_crop_xy(jnifti.NiftiImage(data=data, affine=img_j.affine))
    ct, it = tcrop.body_crop_xy(img_t)
    assert (ij is None) == (it is None)
    if ij is not None:
        assert (ij.x0, ij.x1, ij.y0, ij.y1) == (it.x0, it.x1, it.y0, it.y1)
        np.testing.assert_array_equal(ct.affine, cj.affine)
    # orientation: a flipped, permuted affine
    aff = np.array([[0.0, 0, -2.0, 10], [-1.5, 0, 0, 20], [0, 3.0, 0, -5], [0, 0, 0, 1]])
    vol = np.random.default_rng(0).integers(-1000, 1000, (7, 9, 11)).astype(np.int16)
    gj = jnifti.canonical_geometry(jnifti.NiftiImage(data=vol, affine=aff))
    gt = tnifti.canonical_geometry(tnifti.NiftiImage(data=vol, affine=aff))
    np.testing.assert_array_equal(gj[0], gt[0])
    np.testing.assert_allclose(gj[1], gt[1])
    assert gj[2:] == gt[2:]
    dev = tnifti.apply_orientation_device(torch.from_numpy(vol), gt[0]).numpy()
    np.testing.assert_array_equal(dev, jnifti.apply_orientation(vol, gj[0]))
    inv = tnifti.inv_orientation(gt[0])
    np.testing.assert_array_equal(tnifti.apply_orientation(dev, inv), vol)
    # blob postprocessing
    rng = np.random.default_rng(1)
    seg = (rng.random((20, 18, 16)) < 0.3).astype(np.uint8) * 2
    seg[rng.random(seg.shape) < 0.1] = 1
    cmap = {1: "a", 2: "b"}
    np.testing.assert_array_equal(
        tpost.keep_largest_blob_multilabel(seg, cmap, ["b"]),
        jpost.keep_largest_blob_multilabel(seg, cmap, ["b"]))
    np.testing.assert_array_equal(
        tpost.remove_small_blobs_multilabel(seg, cmap, ["a", "b"], interval=(3, 1e10)),
        jpost.remove_small_blobs_multilabel(seg, cmap, ["a", "b"], interval=(3, 1e10)))


@pytest.fixture(scope="module")
def total_store(tmp_path_factory):
    """A small synthetic `total_fast` (task 297) folder with the reference's
    writer; the seg head is biased like bench.py does, so the labels form
    regions instead of near-tied noise."""
    root = tmp_path_factory.mktemp("weights")
    mdir = create_synthetic_model(root, 297, "TotalSegmentator_total_3mm_1559subj",
                                  num_classes=6,
                                  trainer="nnUNetTrainer_4000epochs_NoMirroring",
                                  patch_size=(32, 32, 32), spacing=(3.0, 3.0, 3.0),
                                  features=(8, 16))
    from boa_tpu.plans.plans import ModelPlans

    path = mdir / "fold_0" / "checkpoint_final.npz"
    p0 = jcv.load_params_npz(path, ModelPlans.from_model_folder(mdir).arch_config())
    head = p0["seg_heads"][-1]
    head["b"] = head["b"] + np.random.default_rng(7).normal(0, 3.0, head["b"].shape
                                                           ).astype(np.float32)
    jcv.save_params_npz(p0, path)
    return root


@pytest.mark.parametrize("dtype,bar", [("float32", 0.995), ("bfloat16", 0.99)])
def test_predict_image_matches_reference(total_store, dtype, bar):
    img_j = jnifti.load(EXAMPLE_CT)
    data = np.array(img_j.data)
    ref = jpipe.predict_image(jnifti.NiftiImage(data=data, affine=img_j.affine),
                              "total", JStore(total_store), fast=True,
                              compute_dtype=dtype)
    res = tpipe.predict_image(tnifti.NiftiImage(data=data, affine=img_j.affine),
                              "total", ModelStore(total_store), fast=True,
                              compute_dtype=dtype, device="cpu")
    got, want = res.seg.data, np.asarray(ref.seg.data)
    assert got.shape == want.shape == data.shape and got.dtype == np.uint8
    np.testing.assert_allclose(res.seg.affine, ref.seg.affine)
    assert res.seg.get_label_map() == ref.seg.get_label_map()
    assert res.seg_model_grid.shape == ref.seg_model_grid.shape
    agree = (got == want).mean()
    assert agree > bar, f"label agreement {agree}"
    assert len(np.unique(want)) > 2  # the comparison is not between empty volumes
