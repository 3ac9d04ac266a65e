"""BCA segmentation postprocessing, on the host.

Counterpart of `boa_tpu/bca/postprocess.py` (body_composition_analysis
`body_regions/postprocess.py` and `body_parts/postprocess.py`):

* regions: keep only the largest 26-connected component of all labels
  together, of thorax ∪ mediastinum ∪ pericardium, of the pericardium and of
  the abdominal cavity; removed fragments become 255 (the ignore value);
* parts: per label, fill each z slice's holes, drop 26-connected objects
  under 3000 voxels and reopen enclosed holes of 3000 voxels or more.

Both run the reference's scipy path (`ops/connected_components.py`). The
slice fill is `scipy.ndimage.binary_fill_holes` on each z slice with the
2-D cross: background that the slice's border does not reach through
4-connected background is filled. That is the reference's native flood fill
and its cv2 external-contour fill (8/4-connectivity duality); here it is
one labelling of the background with a structure that joins voxels only
within a slice. The parts pass computes its labels on threads (three
labellings each, on the label's bounding box) and writes them in label
order, as the reference's loop does.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy import ndimage

from boa_tpu_torch.bca.definitions import BodyRegion
from boa_tpu_torch.ops import connected_components as cc

IGNORE_VALUE = 255

# joins 4-neighbours within a z slice and nothing across slices
_SLICE_CROSS = np.zeros((3, 3, 3), bool)
_SLICE_CROSS[:, :, 1] = ndimage.generate_binary_structure(2, 1)


def _filter_largest_by_lut(seg: np.ndarray, region_labels) -> None:
    lut = np.zeros(256, np.uint8)
    lut[np.atleast_1d(region_labels)] = 1
    cc.keep_largest_lut_inplace(seg, lut, connectivity=3, ignore_value=IGNORE_VALUE)


def postprocess_region_segmentation(seg: np.ndarray) -> np.ndarray:
    out = np.array(seg, dtype=np.uint8, order="C")
    # all labels but background and the ignore value
    _filter_largest_by_lut(out, list(range(1, 255)))
    _filter_largest_by_lut(out, [int(BodyRegion.THORACIC_CAVITY),
                                 int(BodyRegion.MEDIASTINUM),
                                 int(BodyRegion.PERICARDIUM)])
    for region in (BodyRegion.PERICARDIUM, BodyRegion.ABDOMINAL_CAVITY):
        _filter_largest_by_lut(out, int(region))
    return out


def fill_slices(mask: np.ndarray) -> np.ndarray:
    """Bool (x, y, z) mask with each z slice's holes filled."""
    background, n = ndimage.label(~mask, structure=_SLICE_CROSS)
    outside = np.zeros(n + 1, bool)
    for face in (background[0], background[-1], background[:, 0], background[:, -1]):
        outside[np.unique(face)] = True
    outside[0] = False   # label 0 is the mask itself
    return ~outside[background]


def _fill_and_filter(mask: np.ndarray, label_value: int, raw: tuple, threshold: int):
    """(padded bbox, bool mask of the label's voxels after the fill and the
    object and hole rules on it), or None when nothing survives."""
    # the bbox padded by one voxel of background: the fill is local to a
    # slice, and the pad ring keeps the outside background connected
    lo = [max(s.start - 1, 0) for s in raw]
    hi = [min(s.stop + 1, n) for s, n in zip(raw, mask.shape)]
    box = tuple(slice(a, b) for a, b in zip(lo, hi))
    filled = fill_slices(mask[box] == label_value)
    filled = cc.filter_components_by_size(filled, (threshold - 1, np.inf),
                                          connectivity=3).astype(bool)
    if not filled.any():
        return None
    # holes: background components touching a pad-ring face are the outside
    # and always reopen; a face clamped at the volume's edge has no ring, so
    # components there follow the size rule, as over the whole volume
    inv_labels, n = cc.label(~filled, connectivity=3)
    keep = cc.component_sizes(inv_labels, n) >= threshold
    ring_faces = []
    if lo[0] > 0:
        ring_faces.append(inv_labels[0])
    if hi[0] < mask.shape[0]:
        ring_faces.append(inv_labels[-1])
    if lo[1] > 0:
        ring_faces.append(inv_labels[:, 0])
    if hi[1] < mask.shape[1]:
        ring_faces.append(inv_labels[:, -1])
    if lo[2] > 0:
        ring_faces.append(inv_labels[..., 0])
    if hi[2] < mask.shape[2]:
        ring_faces.append(inv_labels[..., -1])
    for face in ring_faces:
        keep[np.unique(face)] = True
    keep[0] = False   # label 0 is the filled foreground
    return box, ~keep[inv_labels]


def remove_small_labeled_objects(mask: np.ndarray, threshold: int = 3000) -> np.ndarray:
    """Per label: fill the z slices, then remove objects and holes smaller
    than `threshold` voxels (skimage's remove_small_objects(max_size =
    threshold - 1) keeps size >= threshold). A later label overwrites an
    earlier one where their results overlap."""
    out = np.zeros(mask.shape, dtype=mask.dtype)
    present = np.flatnonzero(np.bincount(mask.ravel()))
    boxes = ndimage.find_objects(mask, max_label=int(present.max(initial=0)))
    labels = [int(v) for v in present if v and boxes[v - 1] is not None]
    # the labels are independent until they are written, and scipy's
    # labelling releases the interpreter lock: one thread per label
    with ThreadPoolExecutor(max_workers=max(1, min(len(labels), os.cpu_count() or 1))) as pool:
        results = list(pool.map(
            lambda v: _fill_and_filter(mask, v, boxes[v - 1], threshold), labels))
    for label_value, result in zip(labels, results):
        if result is not None:
            box, keep = result
            out[box][keep] = label_value
    return out


def postprocess_part_segmentation(seg: np.ndarray) -> np.ndarray:
    return remove_small_labeled_objects(np.ascontiguousarray(seg, dtype=np.uint8))
