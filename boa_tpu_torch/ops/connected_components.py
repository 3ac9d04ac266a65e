"""Connected components on the host.

Counterpart of `boa_tpu/ops/connected_components.py` (`label`,
`largest_component`, `filter_components_by_size`, `histogram_u8`, `minmax`,
`component_sizes`, `keep_largest_lut_inplace`) on `scipy.ndimage.label` and
numpy, the reference's own substrate (the JAX package's native union-find
library is not used by the port). Connectivity 1 = 6-neighbourhood, 3 = 26.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def label(mask: np.ndarray, connectivity: int = 1) -> tuple[np.ndarray, int]:
    structure = ndimage.generate_binary_structure(3, connectivity)
    labels, n = ndimage.label(np.asarray(mask, dtype=bool), structure=structure)
    return labels.astype(np.int32), int(n)


def largest_component(mask: np.ndarray, connectivity: int = 1) -> np.ndarray:
    """uint8 mask of the largest connected component."""
    labels, n = label(mask, connectivity)
    if n == 0:
        return np.zeros(mask.shape, np.uint8)
    sizes = component_sizes(labels, n)
    sizes[0] = 0
    return (labels == np.argmax(sizes)).astype(np.uint8)


def filter_components_by_size(mask: np.ndarray, interval,
                              connectivity: int = 1) -> np.ndarray:
    """Keep components with interval[0] < size <= interval[1]."""
    labels, n = label(mask, connectivity)
    sizes = component_sizes(labels, n)
    keep = (sizes > interval[0]) & (sizes <= interval[1])
    keep[0] = False
    return keep[labels].astype(np.uint8)


def histogram_u8(data: np.ndarray) -> np.ndarray:
    """256-bin histogram of a uint8 array."""
    return np.bincount(np.ravel(data), minlength=256)[:256]


def minmax(data: np.ndarray) -> tuple[float, float]:
    """(min, max) of an array."""
    return float(data.min()), float(data.max())


def component_sizes(labels: np.ndarray, n: int) -> np.ndarray:
    """Voxel count of each label 0..n of a labelling."""
    return np.bincount(labels.ravel(), minlength=n + 1)


def keep_largest_lut_inplace(seg: np.ndarray, lut: np.ndarray, connectivity: int = 3,
                             ignore_value: int = 255) -> None:
    """Overwrite every component of {lut[seg]} but the largest with
    `ignore_value`, in place. Among components of equal size the one met
    first in C order stays (np.argmax over scipy's labels)."""
    mask = np.asarray(lut, bool)[seg]
    # the mask's bounding box from its axis projections: the labelling and
    # the write-back touch only that box
    proj = [mask.any(axis=(1, 2)), mask.any(axis=(0, 2)), mask.any(axis=(0, 1))]
    if not proj[0].any():
        return
    box = tuple(slice(int(np.argmax(p)), int(len(p) - np.argmax(p[::-1]))) for p in proj)
    labels, n = label(mask[box], connectivity)
    if n <= 1:
        return
    sizes = component_sizes(labels, n)
    sizes[0] = 0
    keep = int(np.argmax(sizes))
    sub = seg[box]
    sub[(labels > 0) & (labels != keep)] = ignore_value
