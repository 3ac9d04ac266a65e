"""Binary morphology with scipy's and skimage's semantics.

Counterpart of `boa_tpu/ops/morphology.py`. The cross operations are
`scipy.ndimage.binary_dilation` / `binary_erosion` with the default cross
structuring element (the 6-neighbourhood) and `iterations=N`, as
TotalSegmentator's postprocessing calls them: one iteration is the max (min)
of the mask and its six one-voxel shifts, with zeros shifted in at the
borders. They run on the host.

The box operations take a tensor and run on its device: an explicit
`F.pad` with the window's asymmetric reach (lo = size // 2 before, hi =
size - 1 - lo after, scipy's centring of an even footprint), then
`F.max_pool3d` with stride 1 and no padding, one axis at a time (a box's max
is the max of its rows' maxima), min as -max(-x). `F.max_pool3d` takes
floating types only, so masks go in as float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def binary_dilation_cross(mask, iterations: int = 1) -> np.ndarray:
    """uint8 mask dilated `iterations` times by the 6-neighbourhood cross."""
    m = torch.from_numpy(np.asarray(mask) > 0)
    for _ in range(iterations):
        out = m.clone()
        for ax in range(3):
            n = m.shape[ax]
            out.narrow(ax, 1, n - 1).logical_or_(m.narrow(ax, 0, n - 1))
            out.narrow(ax, 0, n - 1).logical_or_(m.narrow(ax, 1, n - 1))
        m = out
    return m.to(torch.uint8).numpy()


def binary_erosion_cross(mask, iterations: int = 1) -> np.ndarray:
    """uint8 mask eroded `iterations` times by the 6-neighbourhood cross,
    outside the volume counted as 0 (scipy's border_value=0)."""
    m = torch.from_numpy(np.asarray(mask) > 0)
    for _ in range(iterations):
        m = _iterate_cross_border0(m)
    return m.to(torch.uint8).numpy()


def _iterate_cross_border0(m: torch.Tensor) -> torch.Tensor:
    """One cross erosion of a bool mask with zeros outside."""
    out = m.clone()
    for ax in range(3):
        n = m.shape[ax]
        out.narrow(ax, 1, n - 1).logical_and_(m.narrow(ax, 0, n - 1))
        out.narrow(ax, 0, n - 1).logical_and_(m.narrow(ax, 1, n - 1))
        out.narrow(ax, 0, 1).zero_()
        out.narrow(ax, n - 1, 1).zero_()
    return out


def box_max(x: torch.Tensor, size: int, lo: int, hi: int, value: float) -> torch.Tensor:
    """Max over the size^3 window reaching `lo` voxels back and `hi` ahead,
    `value` outside the volume; x is a float (X, Y, Z) tensor."""
    y = F.pad(x[None, None], (lo, hi) * 3, value=value)
    for k in ((size, 1, 1), (1, size, 1), (1, 1, size)):
        y = F.max_pool3d(y, k, stride=1)
    return y[0, 0]


def erosion_box(mask: torch.Tensor, size: int) -> torch.Tensor:
    """scipy binary_erosion with a size^3 ones footprint: min over the
    window, outside the volume counted as 0 (border_value=0). uint8."""
    lo = size // 2
    out = -box_max(-mask.to(torch.float32), size, lo, size - 1 - lo, 0.0)
    return (out > 0.5).to(torch.uint8)


def erosion_box_border1(mask: torch.Tensor, size: int) -> torch.Tensor:
    """skimage.morphology.binary_erosion with a size^3 box: outside the
    volume counted as 1, so edges do not erode inward; an even size spans
    [-(size // 2), size - 1 - size // 2] (skimage's pad_end). uint8."""
    lo = size // 2
    out = -box_max(-mask.to(torch.float32), size, lo, size - 1 - lo, -1.0)
    return (out > 0.5).to(torch.uint8)


def dilation_box(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Box dilation, outside counted as 0; the window is the mirrored
    footprint, [-(size - 1 - size // 2), size // 2]. uint8."""
    hi = size // 2
    out = box_max(mask.to(torch.float32), size, size - 1 - hi, hi, 0.0)
    return (out > 0.5).to(torch.uint8)


def binary_fill_holes_host(mask: np.ndarray) -> np.ndarray:
    from scipy import ndimage

    return ndimage.binary_fill_holes(mask)


def median_filter_inplane(vol: torch.Tensor, size: int = 3) -> torch.Tensor:
    """In-plane (x, y) 3x3 median, z untouched, on the tensor's device:
    scipy.ndimage.median_filter(size=(3, 3, 1)) with its default 'reflect'
    border, which for a reach of one repeats the edge sample."""
    if size != 3:
        raise ValueError("only a 3x3 in-plane median is supported")
    nx, ny = vol.shape[0], vol.shape[1]
    ix = torch.arange(-1, nx + 1, device=vol.device).clamp_(0, nx - 1)
    iy = torch.arange(-1, ny + 1, device=vol.device).clamp_(0, ny - 1)
    v = vol.index_select(0, ix).index_select(1, iy)
    stack = torch.stack([v[dx:dx + nx, dy:dy + ny] for dx in range(3) for dy in range(3)])
    return stack.median(dim=0).values.to(vol.dtype)
