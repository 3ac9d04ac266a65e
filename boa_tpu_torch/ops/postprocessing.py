"""Multilabel postprocessing on the host.

Counterpart of `keep_largest_blob_multilabel` and
`remove_small_blobs_multilabel` of `boa_tpu/ops/postprocessing.py`
(TotalSegmentator `postprocessing.py:24-43, 77-98`).
"""

from __future__ import annotations

import numpy as np

from boa_tpu_torch.ops import connected_components as cc


def keep_largest_blob_multilabel(data: np.ndarray, class_map: dict[int, str],
                                 rois: list[str]) -> np.ndarray:
    """For each named roi, keep only its largest connected component."""
    out = data.copy()
    inv = {v: k for k, v in class_map.items()}
    for roi in rois:
        roi_mask = data == inv[roi]
        if roi_mask.any():
            out[roi_mask & (cc.largest_component(roi_mask) == 0)] = 0
    return out


def remove_small_blobs_multilabel(data: np.ndarray, class_map: dict[int, str],
                                  rois: list[str], interval=(10, 30)) -> np.ndarray:
    """For each named roi, drop components outside (interval[0], interval[1]]."""
    out = data.copy()
    inv = {v: k for k, v in class_map.items()}
    for roi in rois:
        roi_mask = data == inv[roi]
        if roi_mask.any():
            kept = cc.filter_components_by_size(roi_mask, interval)
            out[roi_mask & (kept == 0)] = 0
    return out
