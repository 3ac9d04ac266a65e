"""Sliding-window fold-ensemble inference with Gaussian-weighted fusion.

Counterpart of `boa_tpu/inference/sliding_window.py` (`tiles_pred`,
`tile_pred`, `sliding_window_logits`, `sliding_window_seg_chunked`). Tiles
are cut from the normalized, padded volume, run through every fold's
network (the mean over folds), weighted by the Gaussian importance map and
added into one channels-last (X, Y, Z, classes) accumulator. The
accumulator is updated in place with slice adds: the reference's chunked
static-index machinery existed to get in-place updates out of XLA and has
no counterpart here. `sliding_window_logits` also sums the Gaussian weights
and divides them out, for logits that are resampled afterwards; the fused
argmax path (`sliding_window_seg_chunked`) skips that, since a per-voxel
positive scale leaves the argmax unchanged.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def mirror_combos(mirror_axes: tuple[int, ...]) -> list[tuple[int, ...]]:
    """All non-empty combinations of spatial flip axes, as axes of the
    (N, X, Y, Z, C) activation layout."""
    axes = [a + 1 for a in mirror_axes]
    return [c for i in range(len(axes)) for c in itertools.combinations(axes, i + 1)]


def _forward_tta(model, x: torch.Tensor, mirror_axes) -> torch.Tensor:
    """Network forward + mirror TTA batched over flips:
    (1, px, py, pz, C) -> (px, py, pz, classes), mean over the flips."""
    combos = mirror_combos(mirror_axes)
    xs = torch.cat([x] + [torch.flip(x, c) for c in combos], dim=0)
    out = model(xs).float()
    parts = [out[0]] + [torch.flip(out[i + 1], [a - 1 for a in c])
                        for i, c in enumerate(combos)]
    return sum(parts) / len(parts)


def tiles_pred(models, vol: torch.Tensor, starts_tb, gauss_w: torch.Tensor,
               compute_dtype, patch_shape, mirror_axes=()) -> torch.Tensor:
    """Gauss-weighted fold-ensemble prediction of a batch of tiles.

    vol (C, X, Y, Z); starts_tb (tb, 3); gauss_w broadcastable against
    (tb, px, py, pz, 1). Returns (tb, px, py, pz, classes) float32. With
    mirror TTA the flips own the batch dimension, so tb must be 1."""
    px, py, pz = patch_shape
    x = torch.stack([vol[:, sx:sx + px, sy:sy + py, sz:sz + pz]
                     for sx, sy, sz in starts_tb])
    x = x.permute(0, 2, 3, 4, 1).to(compute_dtype)
    pred = None
    for model in models:
        if mirror_axes:
            if x.shape[0] != 1:
                raise ValueError("mirror TTA runs one tile at a time")
            p = _forward_tta(model, x, mirror_axes)[None]
        else:
            p = model(x).float()
        pred = p if pred is None else pred + p
    if len(models) > 1:
        pred = pred / len(models)
    return pred * gauss_w


@torch.no_grad()
def sliding_window_logits(models, vol: torch.Tensor, starts: np.ndarray,
                          gaussian, num_classes: int, mirror_axes=(),
                          compute_dtype=torch.bfloat16,
                          accum_dtype=torch.float16) -> torch.Tensor:
    """Gaussian-weight-normalized fused logits, (classes, X, Y, Z) in
    `accum_dtype` (a channels-first view of a channels-last volume).

    Logits and the weight sum accumulate in `accum_dtype`, each tile added
    in float32 and rounded once; the division runs in float32 and rounds
    back, one x-slab at a time (no float32 copy of the whole volume). In
    float16, tile-corner weights are subnormal and can underflow to 0, as
    in the reference. `gaussian`: the tile's (px, py, pz) weights, numpy or
    a tensor (a 2d plan's is an expanded view)."""
    spatial = tuple(vol.shape[-3:])
    px, py, pz = gaussian.shape
    g = torch.as_tensor(gaussian, dtype=torch.float32, device=vol.device)
    logits = torch.zeros(spatial + (num_classes,), dtype=accum_dtype,
                         device=vol.device)
    weights = torch.zeros(spatial, dtype=accum_dtype, device=vol.device)
    for sx, sy, sz in np.asarray(starts, np.int64):
        pred = tiles_pred(models, vol, [(sx, sy, sz)], g[..., None], compute_dtype,
                          (px, py, pz), mirror_axes)[0]
        win = (slice(sx, sx + px), slice(sy, sy + py), slice(sz, sz + pz))
        logits[win] = (logits[win].float() + pred).to(accum_dtype)
        weights[win] = (weights[win].float() + g).to(accum_dtype)
    for x0 in range(0, spatial[0], 16):
        sl = slice(x0, x0 + 16)
        logits[sl] = (logits[sl].float() / weights[sl, ..., None].float()
                      ).to(accum_dtype)
    return logits.permute(3, 0, 1, 2)


@torch.no_grad()
def sliding_window_seg_chunked(models, vol: torch.Tensor, starts: np.ndarray,
                               gaussian, num_classes: int,
                               mirror_axes=(), compute_dtype=torch.bfloat16,
                               accum_dtype=torch.float16, seg_dtype=torch.uint8,
                               revert=None, tile_batch: int = 1) -> torch.Tensor:
    """Fused sliding window -> argmax labels of the unpadded region.

    vol: (C, X, Y, Z) normalized and padded, on the device. starts: host
    (T, 3). revert: per-axis (begin, end) of the unpadded region."""
    spatial = tuple(vol.shape[-3:])
    if revert is None:
        revert = tuple((0, n) for n in spatial)
    px, py, pz = gaussian.shape
    g = torch.as_tensor(gaussian, dtype=torch.float32, device=vol.device)[..., None]
    buf = torch.zeros(spatial + (num_classes,), dtype=accum_dtype,
                      device=vol.device)
    tb = 1 if mirror_axes else max(1, int(tile_batch))
    starts = np.asarray(starts, np.int64)
    for i in range(0, len(starts), tb):
        batch = starts[i:i + tb]
        preds = tiles_pred(models, vol, batch, g, compute_dtype, (px, py, pz),
                           mirror_axes)
        for (sx, sy, sz), p in zip(batch, preds):
            buf[sx:sx + px, sy:sy + py, sz:sz + pz].add_(p.to(accum_dtype))
    rv = tuple(slice(b, e) for b, e in revert)
    return torch.argmax(buf[rv], dim=-1).to(seg_dtype)
