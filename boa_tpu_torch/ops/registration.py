"""Affine image registration by gradient descent, in plain torch on the card.

Counterpart of `boa_tpu/ops/registration.py` (the atlas registration of
TotalSegmentator's `bin/totalseg_evans_index.py` + `registration.py:12+`,
ANTs "AffineFast" to `resources/ct_brain_atlas_1mm.nii.gz`): a few hundred
Adam steps on a normalized-cross-correlation loss, the warp a
differentiable trilinear gather, multi-resolution for capture range. The
reference has no Pallas kernel here; `torch.autograd` takes the place of
`jax.value_and_grad` and a Python loop the place of `jax.lax.scan`.

Parametrization: translation (voxels), rotation (axis-angle, radians),
log-scale per axis (optionally locked), shear. The transform maps FIXED
voxel coordinates to MOVING voxel coordinates about the volume centre (the
resample convention of scipy.ndimage.affine_transform).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device


def affine_warp(vol: torch.Tensor, matrix, out_shape: tuple[int, int, int],
                order: int = 1, cval: float = 0.0) -> torch.Tensor:
    """Sample `vol` at A @ x for every output voxel x (homogeneous 3x4/4x4).

    order 1 = trilinear over the 8 corners (differentiable with respect to
    the matrix and `vol`): `lo` clipped to shape - 2, so the fraction
    reaches 1 at the top edge, and `cval` outside [0, shape - 1]. order 0 =
    nearest (for label maps): rounded (half to even), then masked.
    """
    dev = vol.device
    matrix = torch.as_tensor(matrix, dtype=torch.float32, device=dev)
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev)
                             for s in out_shape], indexing="ij")
    coords = torch.stack([grids[0], grids[1], grids[2], torch.ones_like(grids[0])], dim=-1)
    src = coords.reshape(-1, 4) @ matrix[:3].T  # (N, 3) moving coords

    shape = torch.tensor(vol.shape, dtype=torch.float32, device=dev)
    if order == 0:
        idx = torch.round(src)
        valid = ((idx >= 0) & (idx <= shape - 1)).all(dim=1)
        idx = torch.minimum(torch.clamp(idx, min=0), shape - 1).long()
        out = vol[idx[:, 0], idx[:, 1], idx[:, 2]]
        out = torch.where(valid, out, torch.tensor(cval, dtype=vol.dtype, device=dev))
        return out.reshape(out_shape)

    valid = ((src >= 0) & (src <= shape - 1)).all(dim=1)
    lo_f = torch.minimum(torch.clamp(torch.floor(src), min=0), shape - 2).detach()
    lo = lo_f.long()
    frac = src - lo_f  # after clipping: frac hits 1 at the top edge
    volf = vol.float()
    acc = torch.zeros(src.shape[0], dtype=torch.float32, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                acc = acc + w * volf[lo[:, 0] + dx, lo[:, 1] + dy, lo[:, 2] + dz]
    acc = torch.where(valid, acc, torch.tensor(cval, dtype=torch.float32, device=dev))
    return acc.reshape(out_shape)


class AffineParams(NamedTuple):
    translation: torch.Tensor  # (3,) voxels
    rotation: torch.Tensor     # (3,) axis-angle radians
    log_scale: torch.Tensor    # (3,)
    shear: torch.Tensor        # (3,) xy, xz, yz


def identity_params(device=None) -> AffineParams:
    dev = torch.device("cpu") if device is None else torch.device(device)
    return AffineParams(*(torch.zeros(3, dtype=torch.float32, device=dev) for _ in range(4)))


def _rotation_matrix(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues axis-angle -> 3x3 (differentiable at 0 via a safe norm)."""
    theta2 = torch.sum(r * r)
    theta = torch.sqrt(theta2 + 1e-12)  # eps-smoothed: exact identity at 0,
    k = r / theta                       # nonzero gradient (no where-branch)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    kx = torch.stack([torch.stack([zero, -k[2], k[1]]),
                      torch.stack([k[2], zero, -k[0]]),
                      torch.stack([-k[1], k[0], zero])])
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + torch.sin(theta) * kx + (1 - torch.cos(theta)) * (kx @ kx)


def params_to_matrix(p: AffineParams, fixed_shape, moving_shape) -> torch.Tensor:
    """3x4 matrix mapping fixed voxel coords -> moving voxel coords,
    rotating/scaling about the respective volume centres."""
    dev = p.rotation.device
    rot = _rotation_matrix(p.rotation)
    scale = torch.diag(torch.exp(p.log_scale))
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    shear = torch.stack([torch.stack([one, p.shear[0], p.shear[1]]),
                         torch.stack([zero, one, p.shear[2]]),
                         torch.stack([zero, zero, one])])
    lin = rot @ scale @ shear
    c_fixed = (torch.tensor(tuple(fixed_shape), dtype=torch.float32, device=dev) - 1) / 2
    c_moving = (torch.tensor(tuple(moving_shape), dtype=torch.float32, device=dev) - 1) / 2
    offset = c_moving + p.translation - lin @ c_fixed
    return torch.cat([lin, offset[:, None]], dim=1)


def ncc_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negative normalized cross-correlation (global)."""
    af = a.reshape(-1) - torch.mean(a)
    bf = b.reshape(-1) - torch.mean(b)
    denom = torch.sqrt(torch.sum(af * af) * torch.sum(bf * bf)) + 1e-6
    return -torch.sum(af * bf) / denom


def _downsample(vol: torch.Tensor, factor: int) -> torch.Tensor:
    if factor == 1:
        return vol
    s = [(d // factor) * factor for d in vol.shape]
    v = vol[:s[0], :s[1], :s[2]]
    v = v.reshape(s[0] // factor, factor, s[1] // factor, factor, s[2] // factor, factor)
    return v.mean(dim=(1, 3, 5))


def _register_level(fixed: torch.Tensor, moving: torch.Tensor, init: AffineParams,
                    lr: float, steps: int, with_scale: bool, with_shear: bool
                    ) -> tuple[AffineParams, torch.Tensor]:
    """`steps` Adam steps (optax's adam: b1 0.9, b2 0.999, eps 1e-8 outside
    the square root) from `init`; a locked log-scale or shear has its
    gradient zeroed before each step. Returns the parameters after the last
    step and each step's loss (taken before its update)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in init]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        m = params_to_matrix(AffineParams(*leaves), fixed.shape, moving.shape)
        loss = ncc_loss(fixed, affine_warp(moving, m, tuple(fixed.shape)))
        loss.backward()
        if not with_scale:
            leaves[2].grad.zero_()
        if not with_shear:
            leaves[3].grad.zero_()
        opt.step()
        losses.append(loss.detach())
    return AffineParams(*(t.detach() for t in leaves)), torch.stack(losses)


def register_affine(fixed: np.ndarray, moving: np.ndarray,
                    levels=(4, 2, 1), steps_per_level=150, lr=0.05,
                    with_scale: bool = True, with_shear: bool = False,
                    device=None, spans: dict | None = None
                    ) -> tuple[AffineParams, np.ndarray, float]:
    """Multi-resolution affine registration on `device` (the card by
    default).

    Returns (params as CPU tensors, 3x4 matrix mapping fixed->moving voxel
    coords at FULL resolution, final NCC). Intensity volumes should be
    pre-clipped to the tissue window of interest. `spans`, when given,
    receives each level's seconds as `level_<factor>`.
    """
    dev = resolve_device(device)
    fixed_t = torch.as_tensor(np.asarray(fixed, np.float32), device=dev)
    moving_t = torch.as_tensor(np.asarray(moving, np.float32), device=dev)
    p = identity_params(dev)
    final_loss = 0.0
    for level in levels:
        t0 = time.perf_counter()
        f = _downsample(fixed_t, level)
        m = _downsample(moving_t, level)
        # translation lives in voxels of the current pyramid level
        p_level = p._replace(translation=p.translation / level)
        lr_level = lr if level > 1 else lr * 0.4
        p_level, losses = _register_level(f, m, p_level, lr_level, steps_per_level,
                                          with_scale, with_shear)
        p = p_level._replace(translation=p_level.translation * level)
        final_loss = float(losses[-1])
        if spans is not None:
            spans[f"level_{level}"] = time.perf_counter() - t0
    matrix = params_to_matrix(p, fixed_t.shape, moving_t.shape).cpu().numpy()
    return AffineParams(*(t.cpu() for t in p)), matrix, -final_loss


def warp_labels(labels: np.ndarray, matrix: np.ndarray,
                out_shape: tuple[int, int, int], device=None) -> np.ndarray:
    """Nearest-neighbour warp of a label volume with a fixed->moving matrix
    (labels live on the moving grid; output on the fixed grid), on
    `device` (the card by default)."""
    dev = resolve_device(device)
    out = affine_warp(torch.as_tensor(np.asarray(labels), device=dev),
                      torch.tensor(np.asarray(matrix), dtype=torch.float32),
                      tuple(out_shape), order=0)
    return out.cpu().numpy()
