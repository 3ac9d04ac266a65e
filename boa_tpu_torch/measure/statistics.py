"""Per-class segmentation statistics as counting passes on the device.

Counterpart of `boa_tpu/measure/statistics.py` (TotalSegmentator
`statistics.py:91-141` `get_basic_statistics`): per class, the volume in
mm^3 and the mean or median HU, with the classes that touch a 3-voxel
margin on any face excluded.

The CT is cast to int16 before reducing, as the reference does, so every
number comes from counts of integers and is exact. `segmented_stats`
counts (class, HU) pairs with `torch.bincount` over slabs of the leading
axis (an int32 index of at most `_SLAB_VOXELS` voxels at a time) into an
int64 (C, 4096) histogram, whose counts stay exact above 2^24; the moments
follow from it in float64. Without the histogram, the counts and the
weighted float64 sums come from three bincounts over classes (sums of
integer HU are exact in float64 in any order). The reference's one-hot
reduction would be a (V, C) tensor here: 48 GB at 103 M voxels and 118
classes.
"""

from __future__ import annotations

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device

HU_MIN = -1024
HU_MAX = 3071
N_BINS = HU_MAX - HU_MIN + 1  # one bin per integer HU
_SLAB_VOXELS = 1 << 24


def _slabs(t: torch.Tensor):
    """Views of `t` along its leading axis, about `_SLAB_VOXELS` voxels each."""
    step = max(1, _SLAB_VOXELS // max(1, t[0].numel()))
    return torch.split(t, step, dim=0)


def segmented_stats(seg: torch.Tensor, ct: torch.Tensor, num_classes: int,
                    with_histogram: bool = True) -> dict:
    """Per-class tensors on the inputs' device: `count` (int64), `hu_sum`
    and `hu_sumsq` (float64), `border` (1.0 where the class touches any
    3-voxel face margin, float32) and, with `with_histogram`, `hist`
    (num_classes, N_BINS) int64. Labels at or above `num_classes` are
    dropped, as the reference's segment sums drop them."""
    dev = seg.device
    if with_histogram:
        nb = num_classes * N_BINS
        hist = torch.zeros(nb, dtype=torch.int64, device=dev)
        for s, c in zip(_slabs(seg), _slabs(ct)):
            idx = s.to(torch.int32) * N_BINS + (c.to(torch.int32).clamp(HU_MIN, HU_MAX)
                                                - HU_MIN)
            hist += torch.bincount(idx.ravel(), minlength=nb)[:nb]
        hist = hist.view(num_classes, N_BINS)
        values = torch.arange(HU_MIN, HU_MAX + 1, dtype=torch.float64, device=dev)
        histf = hist.to(torch.float64)
        count = hist.sum(dim=1)
        hu_sum = histf @ values
        hu_sumsq = histf @ (values * values)
    else:
        count = torch.zeros(num_classes, dtype=torch.int64, device=dev)
        hu_sum = torch.zeros(num_classes, dtype=torch.float64, device=dev)
        hu_sumsq = torch.zeros(num_classes, dtype=torch.float64, device=dev)
        for s, c in zip(_slabs(seg), _slabs(ct)):
            s = s.ravel().to(torch.int32)
            cf = c.ravel().to(torch.int32).clamp(HU_MIN, HU_MAX).to(torch.float64)
            count += torch.bincount(s, minlength=num_classes)[:num_classes]
            hu_sum += torch.bincount(s, weights=cf, minlength=num_classes)[:num_classes]
            hu_sumsq += torch.bincount(s, weights=cf * cf,
                                       minlength=num_classes)[:num_classes]

    # border: the classes present in the six 3-voxel face slabs
    x, y, z = seg.shape
    shell = torch.cat([seg[:3].ravel(), seg[x - 3:].ravel(),
                       seg[:, :3].ravel(), seg[:, y - 3:].ravel(),
                       seg[:, :, :3].ravel(), seg[:, :, z - 3:].ravel()]).to(torch.int32)
    border = (torch.bincount(shell, minlength=num_classes)[:num_classes] > 0
              ).to(torch.float32)

    out = {"count": count, "hu_sum": hu_sum, "hu_sumsq": hu_sumsq, "border": border}
    if with_histogram:
        out["hist"] = hist
    return out


def quantile_from_hist(hist: np.ndarray, q: float) -> np.ndarray:
    """Per-class q-quantile (numpy 'linear' method) from integer-HU
    histograms. hist: (C, N_BINS). Exact for integer-valued samples."""
    counts = hist.sum(axis=1)
    cum = np.cumsum(hist, axis=1)
    values = np.arange(HU_MIN, HU_MAX + 1, dtype=np.float64)
    out = np.zeros(hist.shape[0])
    for c in range(hist.shape[0]):
        n = counts[c]
        if n == 0:
            continue
        pos = q * (n - 1)
        lo_idx = int(np.floor(pos))
        hi_idx = min(lo_idx + 1, int(n) - 1)
        frac = pos - lo_idx
        lo_v = values[np.searchsorted(cum[c], lo_idx + 1)]
        hi_v = values[np.searchsorted(cum[c], hi_idx + 1)]
        out[c] = lo_v + (hi_v - lo_v) * frac
    return out


def get_basic_statistics(seg, ct, spacing, class_map: dict[int, str],
                         exclude_masks_at_border: bool = True,
                         metric: str = "mean",
                         roi_subset: list[str] | None = None,
                         normalized_intensities: bool = False,
                         device=None) -> dict:
    """TotalSegmentator statistics dict: {name: {volume, intensity}}.

    `seg` and `ct` are arrays or tensors of one grid. A CT tensor is cast
    to int16 on its device (a float truncates toward zero, as XLA's convert
    does in the reference); an array is cast on the host with numpy's
    semantics, then uploaded to `device` (default the card).
    `normalized_intensities` reports intensities of the min-max-normalized
    CT; the rescale is affine and monotone, so the mean and the median
    commute with it."""
    num_classes = max(class_map.keys()) + 1
    if isinstance(ct, torch.Tensor):
        dev = ct.device
        ct16 = ct.to(torch.int16)
    else:
        dev = resolve_device(device)
        ct16 = torch.from_numpy(np.asarray(ct, dtype=np.int16)).to(dev)
    seg_t = seg.to(dev) if isinstance(seg, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(seg)).to(dev)
    cmin, cscale = 0.0, 1.0
    if normalized_intensities:
        cmin = float(ct16.min())
        cscale = max(float(ct16.max()) - cmin, 1e-8)
    res = segmented_stats(seg_t, ct16, num_classes, with_histogram=(metric == "median"))
    count = res["count"].cpu().numpy()
    hu_sum = res["hu_sum"].cpu().numpy()
    border = res["border"].cpu().numpy()
    if metric == "median":
        med = quantile_from_hist(res["hist"].cpu().numpy(), 0.5)
    vox_vol = float(np.prod(np.asarray(spacing, dtype=np.float64)))

    stats: dict[str, dict] = {}
    for k, name in class_map.items():
        if roi_subset is not None and name not in roi_subset:
            continue
        entry: dict[str, float] = {}
        if exclude_masks_at_border and border[k] > 0:
            entry["volume"] = 0.0
            entry["intensity"] = 0.0
        else:
            entry["volume"] = float(count[k] * vox_vol)
            if count[k] == 0:
                entry["intensity"] = 0.0
            elif metric == "mean":
                entry["intensity"] = float(np.round(
                    (hu_sum[k] / count[k] - cmin) / cscale, 5))
            else:
                entry["intensity"] = float(np.round((med[k] - cmin) / cscale, 5))
        stats[name] = entry
    return stats
