"""The port's per-class statistics (boa_tpu_torch/measure/statistics.py)
against the reference (boa_tpu/measure/statistics.py), same numpy inputs
from a seed, on the CPU.

Bars: counts, histograms and the border indicator exactly equal; the
port's HU sums exact (int64 reference in numpy), the reference's within its
float32 rounding (rtol 1e-6); `quantile_from_hist` equal; the statistics
dict's volumes equal where the voxel volume and its products are exact in
float32, else within the reference's float32 product (rtol 2.4e-7, two
roundings), intensities within 1e-3 HU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boa_tpu.measure import statistics as jst
from boa_tpu.tasks import class_maps as jcm
from boa_tpu_torch.measure import statistics as tst

TOTAL = jcm.get_class_map("total")


def _seg_ct(shape=(30, 28, 26), seed=0, n_labels=118):
    """Blocky labels in [0, n_labels) with an empty 3-voxel shell, one
    class (5) on a face, and CT values beyond the clamp range."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, n_labels, tuple(-(-n // 4) for n in shape))
    seg = np.kron(coarse, np.ones((4, 4, 4), np.int64))[:shape[0], :shape[1], :shape[2]]
    seg = seg.astype(np.uint8)
    inner = np.zeros(shape, bool)
    inner[3:-3, 3:-3, 3:-3] = True
    seg[~inner] = 0
    seg[0:6, 10:14, 10:14] = 5
    ct = rng.integers(-1300, 3300, size=shape).astype(np.int16)
    return seg, ct


@pytest.mark.parametrize("with_histogram", [True, False])
@pytest.mark.parametrize("num_classes", [118, 40])   # 40: labels above are dropped
@pytest.mark.parametrize("slab_voxels", [1 << 24, 1000])   # one slab, many
def test_segmented_stats_matches_reference(monkeypatch, with_histogram, num_classes,
                                           slab_voxels):
    monkeypatch.setattr(tst, "_SLAB_VOXELS", slab_voxels)
    seg, ct = _seg_ct()
    ref = jst.segmented_stats(jnp.asarray(seg), jnp.asarray(ct), num_classes,
                              with_histogram=with_histogram)
    got = tst.segmented_stats(torch.from_numpy(seg), torch.from_numpy(ct), num_classes,
                              with_histogram=with_histogram)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["count"].numpy(), np.asarray(ref["count"]))
    np.testing.assert_array_equal(got["border"].numpy(), np.asarray(ref["border"]))
    if with_histogram:
        assert got["hist"].dtype == torch.int64
        np.testing.assert_array_equal(got["hist"].numpy(), np.asarray(ref["hist"]))
    # the port's sums are exact; the reference's are float32
    ci = np.clip(ct.astype(np.int64), -1024, 3071).ravel()
    keep = seg.ravel() < num_classes
    s1 = np.bincount(seg.ravel()[keep], ci[keep], minlength=num_classes)
    s2 = np.bincount(seg.ravel()[keep], (ci * ci)[keep], minlength=num_classes)
    np.testing.assert_array_equal(got["hu_sum"].numpy(), s1)
    np.testing.assert_array_equal(got["hu_sumsq"].numpy(), s2)
    for k in ("hu_sum", "hu_sumsq"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
    assert got["border"][5] == 1 and got["border"].sum() == 2   # class 5 and background


def test_quantile_from_hist_matches_reference():
    rng = np.random.default_rng(1)
    hist = np.zeros((6, jst.N_BINS))
    for c in range(1, 6):
        vals = rng.integers(-1024, 3072, size=int(rng.integers(1, 500)))
        np.add.at(hist[c], vals + 1024, 1)
    for q in (0.25, 0.5, 0.75):
        got = tst.quantile_from_hist(hist, q)
        np.testing.assert_array_equal(got, jst.quantile_from_hist(hist, q))
        want = [0.0] + [np.quantile(np.repeat(np.arange(-1024, 3072), hist[c].astype(int)),
                                    q) for c in range(1, 6)]
        np.testing.assert_allclose(got, want, atol=1e-9)


CASES = {
    "mean": {},
    "median": {"metric": "median"},
    "normalized_mean": {"normalized_intensities": True},
    "normalized_median": {"normalized_intensities": True, "metric": "median"},
    "keep_border": {"exclude_masks_at_border": False},
    "roi_subset": {"roi_subset": ["spleen", "liver", "aorta", "brain"]},
}


@pytest.mark.parametrize("case", sorted(CASES) + ["float_tensor_ct", "irregular_spacing"])
def test_get_basic_statistics_matches_reference(case):
    seg, ct = _seg_ct(seed=2)
    spacing = (1.5, 1.5, 3.0)   # 6.75 mm^3: volumes exact in float32
    kw = dict(CASES.get(case, {}))
    ct_j, ct_t = ct, ct
    if case == "float_tensor_ct":
        # a resampled CT on the device: the cast truncates toward zero
        ctf = (ct.astype(np.float32) + np.random.default_rng(3).uniform(
            -0.99, 0.99, ct.shape).astype(np.float32))
        ct_j, ct_t = jnp.asarray(ctf), torch.from_numpy(ctf)
    if case == "irregular_spacing":
        spacing = (0.9, 0.8, 1.25)
    ref = jst.get_basic_statistics(seg, ct_j, spacing, TOTAL, **kw)
    got = tst.get_basic_statistics(seg, ct_t, spacing, TOTAL, device="cpu", **kw)
    assert list(got) == list(ref)
    # 1e-3 HU, on the normalized scale 1e-3 HU over the CT's range
    atol = 1e-3
    if kw.get("normalized_intensities"):
        atol /= float(ct.max()) - float(ct.min())
    n_nonzero = 0
    for name, want in ref.items():
        if case == "irregular_spacing":
            np.testing.assert_allclose(got[name]["volume"], want["volume"], rtol=2.4e-7)
        else:
            assert got[name]["volume"] == want["volume"], name
        np.testing.assert_allclose(got[name]["intensity"], want["intensity"], atol=atol)
        n_nonzero += want["volume"] > 0
    assert n_nonzero > (2 if case == "roi_subset" else 50)
    if case == "roi_subset":
        assert sorted(got) == ["aorta", "brain", "liver", "spleen"]
    if case != "keep_border":
        assert got[TOTAL[5]] == {"volume": 0.0, "intensity": 0.0}


def test_get_basic_statistics_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg, ct = _seg_ct((8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.get_basic_statistics(seg, ct, (1.0, 1.0, 1.0), TOTAL)
