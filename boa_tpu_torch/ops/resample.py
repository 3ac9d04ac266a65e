"""Separable spline resampling as three matrix contractions.

Counterpart of `boa_tpu/ops/resample.py`. Each axis is a linear operator:
its (n_out, n_in) matrix is built on the host by pushing an identity
through `scipy.ndimage.map_coordinates` (cubic prefilter included, mode
'nearest'), cached, and applied on the tensor's device with `torch.einsum`
in float32. Two coordinate conventions: 'zoom' (scipy.ndimage.zoom,
align corners; TotalSegmentator's change_spacing) and 'resize'
(skimage.transform.resize, half-pixel; nnU-Net).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy import ndimage as ndi


def _coords_zoom(n_in: int, n_out: int) -> np.ndarray:
    if n_out <= 1 or n_in <= 1:
        return np.zeros(n_out)
    return np.arange(n_out) * (n_in - 1) / (n_out - 1)


def _coords_resize(n_in: int, n_out: int) -> np.ndarray:
    return (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5


@lru_cache(maxsize=512)
def axis_operator(n_in: int, n_out: int, order: int, convention: str) -> np.ndarray:
    """(n_out, n_in) matrix M with out = M @ x for 1D spline resampling."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    coords = {"zoom": _coords_zoom, "resize": _coords_resize}[convention](n_in, n_out)
    eye = np.eye(n_in, dtype=np.float64)
    cgrid = np.stack(
        [np.repeat(coords, n_in), np.tile(np.arange(n_in, dtype=np.float64), n_out)]
    ).reshape(2, n_out, n_in)
    mat = ndi.map_coordinates(eye, cgrid, order=order, mode="nearest",
                              prefilter=order > 1)
    return np.ascontiguousarray(mat, dtype=np.float32)


@lru_cache(maxsize=512)
def axis_nearest_indices(n_in: int, n_out: int, convention: str) -> np.ndarray:
    """Order-0 resampling as a gather index vector (scipy semantics)."""
    return np.argmax(axis_operator(n_in, n_out, 0, convention),
                     axis=1).astype(np.int64)


def compute_new_shape(old_shape, old_spacing, new_spacing) -> tuple[int, ...]:
    """nnU-Net shape rule: round(spacing / new_spacing * n)."""
    return tuple(int(round(i / j * k))
                 for i, j, k in zip(old_spacing, new_spacing, old_shape))


def zoom_output_shape(old_shape, zoom) -> tuple[int, ...]:
    """ndimage.zoom shape rule: round(n * zoom)."""
    return tuple(int(round(n * z)) for n, z in zip(old_shape, zoom))


def _axis_op_windowed(n_in, n_out, order, convention, window) -> np.ndarray:
    """Axis operator, optionally sliced out of the full-grid operator.

    `window = (full_in, full_out, in0, out0)` makes the resample of a crop an
    exact subgrid of the full-grid resample; the weights of columns outside
    the crop fold onto its edge columns (the crop margin is constant air)."""
    if window is None:
        return axis_operator(n_in, n_out, order, convention)
    full_in, full_out, in0, out0 = window
    rows = axis_operator(full_in, full_out, order, convention)[out0:out0 + n_out]
    mat = np.ascontiguousarray(rows[:, in0:in0 + n_in])
    if in0 > 0:
        mat[:, 0] += rows[:, :in0].sum(axis=1)
    if in0 + n_in < full_in:
        mat[:, -1] += rows[:, in0 + n_in:].sum(axis=1)
    return mat


def _axis_idx_windowed(n_in, n_out, convention, window) -> np.ndarray:
    if window is None:
        return axis_nearest_indices(n_in, n_out, convention)
    full_in, full_out, in0, out0 = window
    idx = axis_nearest_indices(full_in, full_out, convention)
    return np.clip(idx[out0:out0 + n_out] - in0, 0, n_in - 1).astype(np.int64)


def resample_volume(vol: torch.Tensor, new_shape, order: int = 3,
                    convention: str = "zoom",
                    separate_z_order: int | None = None,
                    windows=None) -> torch.Tensor:
    """Resample the last 3 axes of `vol` to `new_shape` (float32 result).

    separate_z_order: order of the z axis when it differs from the in-plane
    order (nnU-Net's anisotropic mode). windows: optional per-axis
    (full_in, full_out, in0, out0), see `_axis_op_windowed`."""
    in_shape = vol.shape[-3:]
    z_order = order if separate_z_order is None else separate_z_order
    w = windows or (None, None, None)
    dev = vol.device

    def op(ax, o):
        return torch.from_numpy(_axis_op_windowed(
            in_shape[ax], new_shape[ax], o, convention, w[ax])).to(dev)

    out = torch.einsum("...xyz,ax->...ayz", vol.float(), op(0, order))
    out = torch.einsum("...xyz,by->...xbz", out, op(1, order))
    return torch.einsum("...xyz,cz->...xyc", out, op(2, z_order))


def resample_nearest(vol: torch.Tensor, new_shape, convention: str = "zoom",
                     windows=None) -> torch.Tensor:
    """Order-0 resample of the last 3 axes (labels); a gather, any dtype."""
    in_shape = vol.shape[-3:]
    w = windows or (None, None, None)
    out = vol
    for ax in range(3):
        idx = torch.from_numpy(_axis_idx_windowed(
            in_shape[ax], new_shape[ax], convention, w[ax])).to(vol.device)
        out = torch.index_select(out, vol.dim() - 3 + ax, idx)
    return out


def argmax_chunked(produce, num_classes: int, chunk: int = 8) -> torch.Tensor:
    """argmax over classes of `produce(c0, c1)`, the (c1 - c0, ...) values of
    classes c0..c1-1, taken `chunk` classes at a time with a running (max,
    argmax), so only `chunk` class volumes exist at once; a tie keeps the
    lower class, as one argmax over all classes would. int64 labels."""
    best = idx = None
    for c0 in range(0, num_classes, chunk):
        res = produce(c0, min(c0 + chunk, num_classes))
        m, a = res.amax(dim=0), res.argmax(dim=0) + c0
        if best is None:
            best, idx = m, a
        else:
            idx = torch.where(m > best, a, idx)
            best = torch.maximum(best, m)
    return idx


def resample_seg_onehot(seg: torch.Tensor, new_shape, num_classes: int,
                        order: int = 1, convention: str = "resize",
                        separate_z_order: int | None = None,
                        windows=None) -> torch.Tensor:
    """Label resampling as the argmax of each class's one-hot mask resampled
    with `order` (batchgenerators `resize_segmentation`, nnU-Net's seg
    resample), 8 classes at a time (`argmax_chunked`). Returns `seg`'s
    dtype."""

    def onehot(c0: int, c1: int) -> torch.Tensor:
        cls = torch.arange(c0, c1, device=seg.device)
        oh = (seg[None] == cls.view(-1, 1, 1, 1)).float()
        return resample_volume(oh, new_shape, order=order, convention=convention,
                               separate_z_order=separate_z_order, windows=windows)

    return argmax_chunked(onehot, num_classes).to(seg.dtype)


def resample_nearest_host(vol: np.ndarray, new_shape, convention: str = "zoom",
                          windows=None) -> np.ndarray:
    """Order-0 resample on the host with the same index vectors as
    `resample_nearest` (bit-identical results)."""
    in_shape = vol.shape[-3:]
    w = windows or (None, None, None)
    out = vol
    for axis, (n_in, n_out) in enumerate(zip(in_shape, new_shape)):
        if n_in == n_out and w[axis] is None:
            continue
        idx = _axis_idx_windowed(n_in, n_out, convention, w[axis])
        if n_in == n_out and np.array_equal(idx, np.arange(n_in)):
            continue
        out = np.take(out, idx, axis=axis - 3)
    return out


def change_spacing_shape(old_shape, old_spacing, new_spacing=None,
                         target_shape=None):
    """Shape + zoom math of TotalSegmentator's change_spacing."""
    old_shape = np.asarray(old_shape[:3])
    old_spacing = np.asarray(old_spacing[:3], dtype=np.float64)
    if target_shape is not None:
        zoom = np.asarray(target_shape) / old_shape
        new_spacing = old_spacing / zoom
        out_shape = tuple(int(t) for t in target_shape)
    else:
        new_spacing = np.asarray(new_spacing, dtype=np.float64)
        zoom = old_spacing / new_spacing
        out_shape = zoom_output_shape(old_shape, zoom)
    return out_shape, zoom, new_spacing


def rescale_affine(affine: np.ndarray, zoom) -> np.ndarray:
    """Scale the affine's columns by 1/zoom."""
    new_affine = np.copy(affine)
    for i in range(3):
        new_affine[:3, i] = new_affine[:3, i] / zoom[i]
    return new_affine
