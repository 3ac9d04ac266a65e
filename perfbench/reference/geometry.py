"""The study geometry of the plain reference: frozen copies, numpy and torch.

Each function is a copy of the port's logic, frozen here so that a later
change to the port cannot move the yardstick, and so that the reference
imports nothing of the port:

- `body_crop_xy`: `boa_tpu_torch/ops/cropping.py:body_crop_xy` (the crop box
  only, not the image bookkeeping);
- `io_orientation`, `orientation_affine`, `canonical_geometry`, `apply_orientation`:
  `boa_tpu_torch/io/nifti.py`;
- `axis_operator`, `axis_nearest_indices`, `axis_op_windowed`,
  `axis_idx_windowed`, `zoom_output_shape`: `boa_tpu_torch/ops/resample.py`;
- `resample_windows`: the window arithmetic of
  `boa_tpu_torch/inference/pipeline.py:predict_image` for a body-cropped image;
- `nonzero_box`, `ct_normalize`, `patch_pads`, `compute_steps`,
  `tile_starts`, `gaussian_importance_map`:
  `boa_tpu_torch/ops/preprocess.py` and `boa_tpu_torch/inference/predictor.py:_pads`.

The resample runs in float64 here (the port's in float32).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage as ndi


# --- body crop ---------------------------------------------------------------

def body_crop_xy(data: np.ndarray, zooms, threshold: float = -500.0,
                 margin_mm: float = 16.0, stride: int = 4,
                 min_saving: float = 0.10):
    """(x0, x1, y0, y1) of the in-plane body crop, or None where it would save
    less than `min_saving` of the in-plane area."""
    sx, sy, _ = data.shape
    fg = data[::stride, ::stride, ::stride] > threshold
    px = fg.any(axis=(1, 2))
    py = fg.any(axis=(0, 2))
    if not bool(px.any()):
        return None
    nzx = np.flatnonzero(px)
    nzy = np.flatnonzero(py)
    mx = int(np.ceil(margin_mm / max(zooms[0], 1e-3))) + stride
    my = int(np.ceil(margin_mm / max(zooms[1], 1e-3))) + stride
    x0 = max(0, int(nzx[0]) * stride - mx)
    x1 = min(sx, (int(nzx[-1]) + 1) * stride + mx)
    y0 = max(0, int(nzy[0]) * stride - my)
    y1 = min(sy, (int(nzy[-1]) + 1) * stride + my)

    def _bucket(lo: int, hi: int, n: int) -> tuple[int, int]:
        lo = (lo // 8) * 8
        w = min(n, ((hi - lo + 63) // 64) * 64)
        hi = min(n, lo + w)
        return max(0, hi - w), hi

    x0, x1 = _bucket(x0, x1, sx)
    y0, y1 = _bucket(y0, y1, sy)
    if (x1 - x0) * (y1 - y0) > (1.0 - min_saving) * sx * sy:
        return None
    return x0, x1, y0, y1


# --- orientation -------------------------------------------------------------

def io_orientation(affine: np.ndarray) -> np.ndarray:
    """For each input axis, (RAS output axis, +1/-1 direction)."""
    rzs = affine[:3, :3].copy()
    lengths = np.sqrt((rzs ** 2).sum(axis=0))
    lengths[lengths == 0] = 1
    rzs /= lengths[None, :]
    ornt = np.zeros((3, 2))
    mat = rzs.copy()
    for _ in range(3):
        out_ax, in_ax = np.unravel_index(np.argmax(np.abs(mat)), mat.shape)
        ornt[in_ax, 0] = out_ax
        ornt[in_ax, 1] = 1.0 if mat[out_ax, in_ax] > 0 else -1.0
        mat[out_ax, :] = 0
        mat[:, in_ax] = 0
    return ornt


def orientation_affine(ornt: np.ndarray, shape) -> np.ndarray:
    undo_flip = np.eye(4)
    for ax in range(3):
        if ornt[ax, 1] < 0:
            undo_flip[ax, ax] = -1
            undo_flip[ax, 3] = shape[ax] - 1
    perm = np.argsort(ornt[:, 0])
    perm_aff = np.zeros((4, 4))
    perm_aff[3, 3] = 1
    for out_ax, in_ax in enumerate(perm):
        perm_aff[in_ax, out_ax] = 1
    return undo_flip @ perm_aff


def canonical_geometry(affine: np.ndarray, shape):
    """(ornt, canonical shape, canonical zooms)."""
    ornt = io_orientation(affine)
    new_affine = affine @ orientation_affine(ornt, shape)
    perm = np.argsort(ornt[:, 0])
    cshape = tuple(int(np.asarray(shape)[p]) for p in perm)
    zooms = tuple(float(np.sqrt((new_affine[:3, i] ** 2).sum())) for i in range(3))
    return ornt, cshape, zooms


def apply_orientation(data, ornt: np.ndarray):
    """Flip and reorder the first 3 axes (numpy array or tensor)."""
    flips = [ax for ax in range(3) if ornt[ax, 1] < 0]
    perm = np.argsort(ornt[:, 0]).tolist()
    if isinstance(data, torch.Tensor):
        out = torch.flip(data, dims=flips) if flips else data
        return out.permute(*perm)
    out = np.flip(data, axis=flips) if flips else data
    return np.transpose(out, perm)


# --- resampling operators ----------------------------------------------------

def _coords_zoom(n_in: int, n_out: int) -> np.ndarray:
    if n_out <= 1 or n_in <= 1:
        return np.zeros(n_out)
    return np.arange(n_out) * (n_in - 1) / (n_out - 1)


def axis_operator(n_in: int, n_out: int, order: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix of 1-D spline resampling, scipy.ndimage.zoom's
    coordinates ('zoom' convention, mode 'nearest', cubic prefilter)."""
    if n_in == n_out:
        return np.eye(n_in)
    coords = _coords_zoom(n_in, n_out)
    eye = np.eye(n_in, dtype=np.float64)
    cgrid = np.stack(
        [np.repeat(coords, n_in), np.tile(np.arange(n_in, dtype=np.float64), n_out)]
    ).reshape(2, n_out, n_in)
    return ndi.map_coordinates(eye, cgrid, order=order, mode="nearest",
                               prefilter=order > 1)


def axis_nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    return np.argmax(axis_operator(n_in, n_out, 0).astype(np.float32),
                     axis=1).astype(np.int64)


def axis_op_windowed(n_in, n_out, order, window) -> np.ndarray:
    if window is None:
        return axis_operator(n_in, n_out, order)
    full_in, full_out, in0, out0 = window
    rows = axis_operator(full_in, full_out, order)[out0:out0 + n_out]
    mat = np.ascontiguousarray(rows[:, in0:in0 + n_in])
    if in0 > 0:
        mat[:, 0] += rows[:, :in0].sum(axis=1)
    if in0 + n_in < full_in:
        mat[:, -1] += rows[:, in0 + n_in:].sum(axis=1)
    return mat


def axis_idx_windowed(n_in, n_out, window) -> np.ndarray:
    if window is None:
        return axis_nearest_indices(n_in, n_out)
    full_in, full_out, in0, out0 = window
    idx = axis_nearest_indices(full_in, full_out)
    return np.clip(idx[out0:out0 + n_out] - in0, 0, n_in - 1).astype(np.int64)


def zoom_output_shape(old_shape, zoom) -> tuple[int, ...]:
    return tuple(int(round(n * z)) for n, z in zip(old_shape, zoom))


def resample_windows(crop, ornt, orig_shape, canon_shape, canon_zooms, target):
    """(model-grid shape, forward windows, backward windows) of the order-3
    resample of a body-cropped canonical volume to `target` spacing: the
    cropped model grid is an exact subgrid of the uncropped one."""
    zoom = np.asarray(canon_zooms, np.float64) / np.asarray(target, np.float64)
    out_shape = zoom_output_shape(canon_shape, zoom)
    if crop is None:
        return out_shape, (None,) * 3, (None,) * 3
    x0, x1, y0, y1 = crop
    lo, hi = (x0, y0, 0), (x1, y1, int(orig_shape[2]))
    full_c, off_c = [0, 0, 0], [0, 0, 0]
    for i in range(3):
        p = int(ornt[i, 0])
        ext = int(orig_shape[i])
        full_c[p] = ext
        off_c[p] = (ext - hi[i]) if ornt[i, 1] < 0 else lo[i]
    full_out = zoom_output_shape(full_c, zoom)
    out0 = [min(max(int(round(off_c[p] * float(zoom[p]))), 0),
                full_out[p] - out_shape[p]) for p in range(3)]
    fwd = tuple(None if (full_c[p] == canon_shape[p] and full_out[p] == out_shape[p])
                else (full_c[p], full_out[p], off_c[p], out0[p]) for p in range(3))
    bwd = tuple(None if w is None else (w[1], w[0], w[3], w[2]) for w in fwd)
    return out_shape, fwd, bwd


def resample_cubic(vol: torch.Tensor, out_shape, windows) -> torch.Tensor:
    """Order-3 resample of a 3-D tensor, float64, axis by axis."""
    ops = [torch.from_numpy(axis_op_windowed(vol.shape[a], out_shape[a], 3, windows[a]))
           .to(vol.device) for a in range(3)]
    out = torch.einsum("xyz,ax->ayz", vol.double(), ops[0])
    out = torch.einsum("xyz,by->xbz", out, ops[1])
    return torch.einsum("xyz,cz->xyc", out, ops[2])


# --- the predictor's preparation --------------------------------------------

def nonzero_box(vol: torch.Tensor) -> list[tuple[int, int]]:
    nz = vol != 0
    out = []
    for ax in range(3):
        line = nz.any(dim=tuple(i for i in range(3) if i != ax)).cpu().numpy()
        idx = np.flatnonzero(line)
        out.append((int(idx[0]), int(idx[-1]) + 1) if idx.size else (0, vol.shape[ax]))
    return out


def ct_normalize(vol: torch.Tensor, props: dict) -> torch.Tensor:
    std = max(float(props["std"]), 1e-8)
    v = torch.clamp(vol.float(), float(props["percentile_00_5"]),
                    float(props["percentile_99_5"]))
    return (v - float(props["mean"])) / std


def patch_pads(spatial, patch) -> list[tuple[int, int]]:
    """Centred zero padding up to the patch."""
    pads = []
    for n, p in zip(spatial, patch):
        d = max(p, n) - n
        pads.append((d // 2, d - d // 2))
    return pads


def compute_steps(image_size, tile_size, step_fraction: float) -> list[list[int]]:
    target = [t * step_fraction for t in tile_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target, tile_size)]
    steps = []
    for dim in range(len(tile_size)):
        max_step = image_size[dim] - tile_size[dim]
        actual = max_step / (num_steps[dim] - 1) if num_steps[dim] > 1 else 1e11
        steps.append([int(np.round(actual * i)) for i in range(num_steps[dim])])
    return steps


def tile_starts(image_size, tile_size, step_fraction: float) -> np.ndarray:
    steps = compute_steps(image_size, tile_size, step_fraction)
    return np.asarray([(a, b, c) for a in steps[0] for b in steps[1] for c in steps[2]],
                      dtype=np.int64)


def gaussian_importance_map(patch_size, sigma_scale: float = 1.0 / 8,
                            value_scaling: float = 10.0) -> np.ndarray:
    tmp = np.zeros(patch_size)
    tmp[tuple(i // 2 for i in patch_size)] = 1
    g = ndi.gaussian_filter(tmp, [i * sigma_scale for i in patch_size], 0,
                            mode="constant", cval=0)
    g = (g / g.max() * value_scaling).astype(np.float16)
    mask = g == 0
    if mask.any():
        g[mask] = g[~mask].min()
    return g.astype(np.float32)
