"""The plain reference of the nnU-Net predictor's sliding window, and the
reduction of the judged voxels to the readings that decide `correct`.

`fused_logits` works out what the port's sliding window computes on a
volume already on the model grid: the crop to the nonzero box, the CT
normalization, the padding to the patch and the Gaussian-fused tiles of
one model in float32 (the family's `forward`), worked out again from the
CT and the weights that the benchmark made (never from anything the port
derived). A front (`fronts/<front>.py`) brings its entry point's geometry
and judges the written labels by their logit gap: at each voxel, how far
the reference's logit of the label the program wrote lies below the
reference's best logit there. `summarize` reduces those gaps.
"""

from __future__ import annotations

import torch

from perfbench.reference import geometry as geo
from perfbench.reference import unet


def fused_logits(forward, params: dict, cfg: dict, n_cls: int, vol: torch.Tensor, *,
                 fp8: bool = False) -> torch.Tensor:
    """Weight-normalized Gaussian-fused sliding-window logits of one model of
    `n_cls` classes, (classes, X, Y, Z) float32 on the model grid of `vol`
    (the CT's int32 values there), by the family's `forward`
    (`nets/<family>.py`; `cfg`: the configuration file's dict)."""
    dev = vol.device
    patch = tuple(cfg["patch_size"])
    box = geo.nonzero_box(vol)
    sub = vol[tuple(slice(a, b) for a, b in box)]
    v = geo.ct_normalize(sub, cfg["intensity"])
    pads = geo.patch_pads(tuple(v.shape), patch)
    v = torch.nn.functional.pad(v, [q for (a, b) in reversed(pads) for q in (a, b)])
    padded = tuple(v.shape)
    g = torch.from_numpy(geo.gaussian_importance_map(patch)).to(dev)
    acc = torch.zeros((n_cls,) + padded, dtype=torch.float32, device=dev)
    wsum = torch.zeros(padded, dtype=torch.float32, device=dev)
    px, py, pz = patch
    with unet.exact_float32():
        for sx, sy, sz in geo.tile_starts(padded, patch, cfg["step_size"]):
            win = (slice(sx, sx + px), slice(sy, sy + py), slice(sz, sz + pz))
            tile = v[win][None, None]
            acc[(slice(None),) + win] += forward(params, cfg["network"], tile, fp8=fp8)[0] * g
            wsum[win] += g
    inner = tuple(slice(a, a + n) for (a, _), n in zip(pads, sub.shape))
    out = acc[(slice(None),) + inner] / wsum[inner]
    if all(a == 0 and b == n for (a, b), n in zip(box, vol.shape)):
        return out
    # outside the nonzero box the port writes background: there the reference
    # gives background the lead
    full = torch.full((n_cls,) + tuple(vol.shape), -1e4, dtype=torch.float32, device=dev)
    full[0] = 0.0
    full[(slice(None),) + tuple(slice(a, b) for a, b in box)] = out
    return full


def summarize(gaps: list, label_faults: int) -> dict:
    """The readings over every judged voxel of every checked study: the widest
    gap, the gap that 0.1 % of the voxels reach or pass (`gap_p999`), the mean
    gap, the share of voxels whose written label is not the reference's
    first (gap above 0, "flipped"), the mean gap of the flipped voxels, the
    voxel count and the label faults (labels out of range, or set outside
    the body crop)."""
    if not gaps:
        return {"gap_max": 0.0, "gap_p999": 0.0, "gap_mean": 0.0, "flip_share": 0.0,
                "flip_gap_mean": 0.0, "voxels": 0, "label_faults": label_faults}
    allg = torch.cat(gaps)
    k = max(1, allg.numel() // 1000)
    flipped = allg[allg > 0]
    return {"gap_max": float(allg.max()),
            "gap_p999": float(torch.topk(allg, k).values.min()),
            "gap_mean": float(allg.double().mean()),
            "flip_share": flipped.numel() / allg.numel(),
            "flip_gap_mean": float(flipped.double().mean()) if flipped.numel() else 0.0,
            "voxels": int(allg.numel()), "label_faults": label_faults}
