"""Multilabel postprocessing on the host.

Counterpart of `boa_tpu/ops/postprocessing.py` (TotalSegmentator
`postprocessing.py`): keep the largest blob or drop small blobs per label,
zero labels outside a dilated mask, the skin band of a body mask, and strip
a task's training-only auxiliary labels.
"""

from __future__ import annotations

import numpy as np

from boa_tpu_torch.ops import connected_components as cc
from boa_tpu_torch.ops import morphology


def keep_largest_blob(mask: np.ndarray) -> np.ndarray:
    return cc.largest_component(mask > 0.5, connectivity=1)


def keep_largest_blob_multilabel(data: np.ndarray, class_map: dict[int, str],
                                 rois: list[str]) -> np.ndarray:
    """For each named roi, keep only its largest connected component."""
    out = data.copy()
    inv = {v: k for k, v in class_map.items()}
    for roi in rois:
        roi_mask = data == inv[roi]
        if roi_mask.any():
            out[roi_mask & (keep_largest_blob(roi_mask) == 0)] = 0
    return out


def remove_small_blobs(mask: np.ndarray, interval=(10, 30)) -> np.ndarray:
    """uint8 mask of the components with interval[0] < size <= interval[1]."""
    return cc.filter_components_by_size(mask > 0.5, interval, connectivity=1)


def remove_small_blobs_multilabel(data: np.ndarray, class_map: dict[int, str],
                                  rois: list[str], interval=(10, 30)) -> np.ndarray:
    """For each named roi, drop components outside (interval[0], interval[1]]."""
    out = data.copy()
    inv = {v: k for k, v in class_map.items()}
    for roi in rois:
        roi_mask = data == inv[roi]
        if roi_mask.any():
            out[roi_mask & (remove_small_blobs(roi_mask, interval) == 0)] = 0
    return out


def remove_outside_of_mask(seg: np.ndarray, mask: np.ndarray,
                           addon: int = 1) -> np.ndarray:
    """Zero the labels outside the mask dilated `addon` times by the cross."""
    dilated = morphology.binary_dilation_cross(mask > 0.5, iterations=addon)
    out = seg.copy()
    out[dilated == 0] = 0
    return out


def extract_skin(ct_data: np.ndarray, body_mask: np.ndarray) -> np.ndarray:
    """Skin: the body dilated once less the body eroded three times (the
    6-neighbourhood cross), kept where -200 < HU < 250, without blobs of
    under 5 voxels (TotalSegmentator `postprocessing.py:134-164`)."""
    body = (body_mask > 0.5).astype(np.uint8)
    outer = morphology.binary_dilation_cross(body, iterations=1)
    inner = morphology.binary_erosion_cross(body, iterations=3)
    skin = ((outer.astype(np.int8) - inner.astype(np.int8)) > 0).astype(np.uint8)
    skin[ct_data <= -200] = 0
    skin[ct_data >= 250] = 0
    skin = remove_small_blobs(skin, interval=(5, 1e10))
    return skin.astype(np.uint8)


def remove_auxiliary_labels(seg: np.ndarray, task_name: str) -> np.ndarray:
    """Zero the labels of the task's `{task}_auxiliary` class map, where one
    exists (appendicular_bones, face_mr, kidney_cysts)."""
    from boa_tpu_torch.tasks import class_maps

    if task_name + "_auxiliary" not in class_maps.class_map:
        return seg
    aux = class_maps.get_class_map(task_name + "_auxiliary")
    lut = np.arange(max(int(seg.max()), max(aux)) + 1, dtype=seg.dtype)
    lut[[int(i) for i in aux]] = 0
    return lut[seg]
