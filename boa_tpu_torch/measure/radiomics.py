"""First-order and shape radiomics features per segmentation class.

Counterpart of `boa_tpu/measure/radiomics.py` (TotalSegmentator
`statistics.py:16-61` `get_radiomics_features*`, which shells out to
pyradiomics): the first-order class (energy, total energy, entropy,
min/max/mean/median, percentiles, IQR, variance, skewness, kurtosis, MAD,
robust MAD, RMS, uniformity) and the shape class (measure/shape.py, on the
host).

An integer CT inside the histogram's HU range takes one pass on the device:
the per-class integer-HU histogram of `measure/statistics.py:segmented_stats`
(int64 `torch.bincount`), downloaded once; every first-order feature is a
functional of it and follows on the host. Other CTs (float, or a voxel
outside [-1024, 3071] that the histogram would clip) take the exact direct
branch, `ct[seg == label]` per class, as the reference does.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.utils.timing import Spans

logger = logging.getLogger(__name__)


def first_order_features(values: np.ndarray, ml_per_voxel: float) -> dict:
    if values.size == 0:
        return {"present": False}
    v = values.astype(np.float64)
    n = v.size
    mean = v.mean()
    centered = v - mean
    var = centered.var()
    std = np.sqrt(var)
    hist, _ = np.histogram(v, bins=64)
    p = hist / n
    p = p[p > 0]
    q10, q25, med, q75, q90 = np.percentile(v, [10, 25, 50, 75, 90])
    robust = v[(v >= q10) & (v <= q90)]
    return {
        "present": True,
        "voxels": int(n),
        "volume_ml": float(n * ml_per_voxel),
        "energy": float((v ** 2).sum()),
        "entropy": float(-(p * np.log2(p)).sum()),
        "minimum": float(v.min()),
        "maximum": float(v.max()),
        "mean": float(mean),
        "median": float(med),
        "percentile_10": float(q10),
        "percentile_90": float(q90),
        "interquartile_range": float(q75 - q25),
        "range": float(v.max() - v.min()),
        "mean_absolute_deviation": float(np.abs(centered).mean()),
        "robust_mean_absolute_deviation": float(
            np.abs(robust - robust.mean()).mean()) if robust.size else 0.0,
        "total_energy": float((v ** 2).sum() * ml_per_voxel * 1000.0),
        "root_mean_squared": float(np.sqrt((v ** 2).mean())),
        "variance": float(var),
        "skewness": float((centered ** 3).mean() / std ** 3) if std > 0 else 0.0,
        "kurtosis": float((centered ** 4).mean() / std ** 4) if std > 0 else 0.0,
        "uniformity": float((p ** 2).sum()),
    }


def _features_from_hist(hist: np.ndarray, values: np.ndarray,
                        ml_per_voxel: float) -> dict:
    """First-order features exactly from an integer-value histogram.

    Every feature of `first_order_features` is a functional of the value
    counts: moments and MAD are histogram contractions, percentiles come
    from the cumulative counts (numpy's 'linear' method), and the 64-bin
    entropy/uniformity rebin is exact because each integer value falls in
    exactly one equal-width bin.
    """
    h = hist.astype(np.float64)
    n = h.sum()
    if n == 0:
        return {"present": False}
    v = values.astype(np.float64)
    mean = float((h * v).sum() / n)
    centered = v - mean
    var = float((h * centered ** 2).sum() / n)
    std = np.sqrt(var)
    nz = np.nonzero(hist)[0]
    vmin, vmax = float(v[nz[0]]), float(v[nz[-1]])
    # exact 64-equal-width-bin rebin over [vmin, vmax]: np.histogram's
    # linspace edges and half-open bins (the last one closed)
    if vmax > vmin:
        edges = np.linspace(vmin, vmax, 65)
        bin_of = np.minimum(np.searchsorted(edges, v[nz], side="right") - 1, 63)
        p = np.bincount(bin_of, weights=h[nz], minlength=64) / n
    else:
        p = np.array([1.0])
    p = p[p > 0]
    cum = np.cumsum(h)

    def q(frac: float) -> float:
        pos = frac * (n - 1)
        lo_idx = int(np.floor(pos))
        hi_idx = min(lo_idx + 1, int(n) - 1)
        lo_v = v[np.searchsorted(cum, lo_idx + 1)]
        hi_v = v[np.searchsorted(cum, hi_idx + 1)]
        return float(lo_v + (hi_v - lo_v) * (pos - lo_idx))

    q25, q75 = q(0.25), q(0.75)
    q10v, q90v = q(0.10), q(0.90)
    rm = (v >= q10v) & (v <= q90v)
    rn = float(h[rm].sum())
    if rn > 0:
        rmean = float((h[rm] * v[rm]).sum() / rn)
        robust_mad = float((h[rm] * np.abs(v[rm] - rmean)).sum() / rn)
    else:
        robust_mad = 0.0
    return {
        "present": True,
        "voxels": int(n),
        "volume_ml": float(n * ml_per_voxel),
        "energy": float((h * v ** 2).sum()),
        "entropy": float(-(p * np.log2(p)).sum()),
        "minimum": vmin,
        "maximum": vmax,
        "mean": mean,
        "median": q(0.5),
        "percentile_10": q(0.10),
        "percentile_90": q(0.90),
        "interquartile_range": float(q75 - q25),
        "range": float(vmax - vmin),
        "mean_absolute_deviation": float((h * np.abs(centered)).sum() / n),
        "robust_mean_absolute_deviation": robust_mad,
        "total_energy": float((h * v ** 2).sum() * ml_per_voxel * 1000.0),
        "root_mean_squared": float(np.sqrt((h * v ** 2).sum() / n)),
        "variance": var,
        "skewness": float((h * centered ** 3).sum() / n / std ** 3)
        if std > 0 else 0.0,
        "kurtosis": float((h * centered ** 4).sum() / n / std ** 4)
        if std > 0 else 0.0,
        "uniformity": float((p ** 2).sum()),
    }


def _add_shape_features(out: dict, seg_np: np.ndarray, spacing,
                        label_map: dict[int, str]) -> None:
    """Per-class shape features (measure/shape.py) on each class's bounding
    box, the boxes from one scipy `find_objects` pass."""
    from scipy import ndimage

    from boa_tpu_torch.measure.shape import shape_features

    objs = ndimage.find_objects(seg_np.astype(np.int32, copy=False),
                                max_label=int(max(label_map)))
    empty = shape_features(np.zeros((1, 1, 1), bool), spacing)
    for label, name in label_map.items():
        if label == 0 or name not in out:
            continue
        sl = objs[label - 1] if label - 1 < len(objs) else None
        if sl is None:
            out[name].update(empty)
        else:
            out[name].update(shape_features(seg_np[sl] == label, spacing))


def get_radiomics_features(ct_data: np.ndarray, seg: np.ndarray, spacing,
                           label_map: dict[int, str], with_shape: bool = True,
                           device=None, spans: dict | None = None) -> dict:
    """Per-class first-order and shape features (the two classes the
    reference enables, `totalsegmentator/statistics.py:43-55`).

    An integer CT within [-1024, 3071] takes the histogram branch on
    `device` (default: the card); any other CT the exact direct branch on
    the host; a missing card raises on either. `spans`, when given,
    receives `radiomics_histogram` (the device pass and its download, or
    the direct branch) and `radiomics_shape`."""
    from boa_tpu_torch.measure.statistics import HU_MIN, N_BINS, segmented_stats

    ml_per_voxel = float(np.prod(spacing)) / 1000.0
    out = {}
    ct_np = np.asarray(ct_data)
    seg_np = np.asarray(seg)
    in_hu_range = (np.issubdtype(ct_np.dtype, np.integer)
                   and int(ct_np.min()) >= -1024 and int(ct_np.max()) <= 3071)
    dev = resolve_device(device)
    sp = Spans(spans, dev)
    if in_hu_range:
        num_classes = max(label_map) + 1
        res = segmented_stats(
            torch.from_numpy(np.require(seg_np, requirements=["C", "W"])).to(dev),
            torch.from_numpy(np.require(ct_np, np.int16, ["C", "W"])).to(dev),
            num_classes, with_histogram=True)
        hists = res["hist"].cpu().numpy()
        values = np.arange(HU_MIN, HU_MIN + N_BINS, dtype=np.float64)
        for label, name in label_map.items():
            if label == 0:
                continue
            out[name] = _features_from_hist(hists[label], values, ml_per_voxel)
    else:
        for label, name in label_map.items():
            if label == 0:
                continue
            out[name] = first_order_features(ct_np[seg_np == label], ml_per_voxel)
    sp.mark("radiomics_histogram")
    if with_shape:
        _add_shape_features(out, seg_np, spacing, label_map)
        sp.mark("radiomics_shape")
    return out


def get_radiomics_features_for_entire_dir(ct_path: Path, seg_dir: Path, out_file: Path,
                                          device=None) -> dict:
    """Per-model radiomics over every *.nii.gz segmentation in `seg_dir` on
    the CT's grid, written to `out_file`."""
    from boa_tpu_torch.io import nifti

    ct_img = nifti.load(Path(ct_path)) if not hasattr(ct_path, "data") else ct_path
    ct_data = np.asarray(ct_img.data)
    results = {}
    for seg_file in sorted(Path(seg_dir).glob("*.nii.gz")):
        if seg_file.name in ("image.nii.gz", "tissues_5mm.nii.gz"):
            continue
        seg_img = nifti.load(seg_file)
        if seg_img.shape != ct_img.shape:
            continue
        label_map = seg_img.get_label_map()
        if not label_map:
            labels = np.unique(np.asarray(seg_img.data))
            label_map = {int(lb): f"label_{int(lb)}" for lb in labels if lb}
        results[seg_file.name.removesuffix(".nii.gz")] = get_radiomics_features(
            ct_data, np.asarray(seg_img.data), ct_img.zooms, label_map, device=device)
    Path(out_file).write_text(json.dumps(results, indent=2))
    return results
