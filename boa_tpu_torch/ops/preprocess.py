"""Preprocessing: nonzero bbox (host `nonzero_bbox`, device `bbox_array`),
CT / z-score normalization, tile grid,
Gaussian fusion weights.

Counterpart of `boa_tpu/ops/preprocess.py`. The tile grid and the Gaussian
map are host numpy (shape math); normalization runs on the tensor's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def nonzero_bbox(vol: np.ndarray) -> tuple[tuple[int, int], ...]:
    """(start, stop) per axis of the nonzero region of the last 3 axes of a
    host (X, Y, Z) or (C, X, Y, Z) volume (nnU-Net's create_nonzero_mask
    box); the full extent when the volume is all zero."""
    v = np.asarray(vol)
    nz = (v != 0).any(axis=0) if v.ndim == 4 else v != 0
    out = []
    for ax in range(3):
        idx = np.flatnonzero(nz.any(axis=tuple(i for i in range(3) if i != ax)))
        out.append((int(idx[0]), int(idx[-1]) + 1) if idx.size else (0, nz.shape[ax]))
    return tuple(out)


def bbox_array(vol: torch.Tensor) -> np.ndarray:
    """(3, 2) [start, stop) nonzero bounding box of the last 3 axes, with one
    host sync; the full extent when the volume is all zero."""
    nz = (vol != 0).any(dim=0) if vol.dim() == 4 else vol != 0
    lines = torch.cat([nz.any(dim=tuple(i for i in range(3) if i != ax))
                       for ax in range(3)]).cpu().numpy()
    out = np.zeros((3, 2), np.int64)
    start = 0
    for ax, n in enumerate(nz.shape):
        idx = np.flatnonzero(lines[start:start + n])
        out[ax] = (idx[0], idx[-1] + 1) if idx.size else (0, n)
        start += n
    return out


def ct_normalize(vol: torch.Tensor, props: dict) -> torch.Tensor:
    """CTNormalization: clip to the fingerprint percentiles, z-score."""
    std = max(float(props["std"]), 1e-8)
    v = torch.clamp(vol.float(), float(props["percentile_00_5"]),
                    float(props["percentile_99_5"]))
    return (v - float(props["mean"])) / std


def zscore_normalize(vol: torch.Tensor) -> torch.Tensor:
    v = vol.float()
    return (v - v.mean()) / torch.clamp(v.std(unbiased=False), min=1e-8)


def compute_steps(image_size, tile_size, step_fraction: float) -> list[list[int]]:
    """Evenly spaced sliding-window steps (nnU-Net
    `sliding_window_prediction.py:30-54`)."""
    assert all(i >= j for i, j in zip(image_size, tile_size))
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
    """(T, 3) int32 tile start coordinates, x-major."""
    steps = compute_steps(image_size, tile_size, step_fraction)
    out = [(sx, sy, sz) for sx in steps[0] for sy in steps[1] for sz in steps[2]]
    return np.asarray(out, dtype=np.int32)


def gaussian_importance_map(patch_size, sigma_scale: float = 1.0 / 8,
                            value_scaling: float = 10.0) -> np.ndarray:
    """Gaussian tile-fusion weights: impulse at the centre voxel, gaussian
    filter with sigma = patch/8, max scaled to `value_scaling`, rounded
    through fp16 with zeros clamped to the smallest nonzero value. Built once
    per patch shape (at 128^3 the filter is a long host pass, which every
    study would otherwise pay) and returned as a fresh copy."""
    return _gaussian(tuple(int(p) for p in patch_size), float(sigma_scale),
                     float(value_scaling)).copy()


@lru_cache(maxsize=8)
def _gaussian(patch_size, sigma_scale, value_scaling) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    tmp = np.zeros(patch_size)
    tmp[tuple(i // 2 for i in patch_size)] = 1
    g = gaussian_filter(tmp, [i * sigma_scale for i in patch_size], 0,
                        mode="constant", cval=0)
    g = (g / g.max() * value_scaling).astype(np.float16)
    mask = g == 0
    if mask.any():
        g[mask] = g[~mask].min()
    return g.astype(np.float32)
