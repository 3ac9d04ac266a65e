"""The plain reference of one study, and the comparison that decides `correct`.

What the port's timed path computes for a CT, worked out again from the CT
and the weights that the benchmark made (never from anything the port
derived): the in-plane body crop, the canonical orientation, the order-3
resample to the model grid, the CT normalization, the padding to the patch, the
Gaussian-fused sliding window of every sub-model in float32
(`reference/unet.py`), and the map from each voxel of the written
`total.nii.gz` back to the model-grid voxel its label came from (the
order-0 back-resample, the inverse orientation and the pad-back).

The port's written labels are then judged by their logit gap: at each
voxel, how far the reference's logit of the label the port wrote lies below
the reference's best logit there. For a task of several sub-models merged
by the label table (later sub-models over earlier ones), a written label
of part k says that sub-model k chose that label and every later sub-model
chose background; background says every sub-model chose background; the
gap of the voxel is the largest over those statements.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import geometry as geo
from perfbench.reference import unet


class StudyGeometry:
    """The reference's geometry of one CT (orig int16 array + affine) for a
    configuration's grid."""

    def __init__(self, ct: np.ndarray, affine: np.ndarray, spacing, device):
        self.orig_shape = tuple(int(n) for n in ct.shape)
        zooms = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
        self.crop = geo.body_crop_xy(ct, zooms)
        if self.crop is None:
            x0, x1, y0, y1 = 0, ct.shape[0], 0, ct.shape[1]
            aff = affine
        else:
            x0, x1, y0, y1 = self.crop
            aff = np.array(affine, np.float64, copy=True)
            aff[:3, 3] = (aff @ np.array([x0, y0, 0.0, 1.0]))[:3]
        self.box = (x0, x1, y0, y1)
        cropped = ct[x0:x1, y0:y1]
        self.ornt, self.canon_shape, self.canon_zooms = geo.canonical_geometry(
            aff, cropped.shape)
        canon = geo.apply_orientation(torch.from_numpy(np.ascontiguousarray(cropped))
                                      .to(device), self.ornt)
        if np.allclose(self.canon_zooms, spacing):
            self.model_shape = self.canon_shape
            self.bwd = (None,) * 3
            self.volume = canon.to(torch.int32)
        else:
            self.model_shape, fwd, self.bwd = geo.resample_windows(
                self.crop, self.ornt, self.orig_shape, self.canon_shape,
                self.canon_zooms, spacing)
            # truncated toward zero, as the port's int32 cast
            self.volume = geo.resample_cubic(canon, self.model_shape, fwd).to(torch.int32)
        # model-grid index of each canonical voxel, per axis
        self.index = [torch.from_numpy(geo.axis_idx_windowed(
            self.model_shape[a], self.canon_shape[a], self.bwd[a])).to(device)
            for a in range(3)]


def fused_logits(params: dict, cfg: dict, geom: StudyGeometry, *,
                 fp8: bool = False) -> torch.Tensor:
    """Weight-normalized Gaussian-fused sliding-window logits of one model,
    (classes, X, Y, Z) float32 on the model grid (`cfg`: the configuration
    file's dict)."""
    vol = geom.volume
    dev = vol.device
    patch = tuple(cfg["patch_size"])
    box = geo.nonzero_box(vol)
    sub = vol[tuple(slice(a, b) for a, b in box)]
    v = geo.ct_normalize(sub, cfg["intensity"])
    pads = geo.patch_pads(tuple(v.shape), patch)
    v = torch.nn.functional.pad(v, [q for (a, b) in reversed(pads) for q in (a, b)])
    padded = tuple(v.shape)
    g = torch.from_numpy(geo.gaussian_importance_map(patch)).to(dev)
    n_cls = int(params["seg_heads"][-1]["b"].shape[0])
    acc = torch.zeros((n_cls,) + padded, dtype=torch.float32, device=dev)
    wsum = torch.zeros(padded, dtype=torch.float32, device=dev)
    px, py, pz = patch
    with unet.exact_float32():
        for sx, sy, sz in geo.tile_starts(padded, patch, cfg["step_size"]):
            win = (slice(sx, sx + px), slice(sy, sy + py), slice(sz, sz + pz))
            tile = v[win][None, None]
            acc[(slice(None),) + win] += unet.forward(params, cfg["network"], tile,
                                                      fp8=fp8)[0] * g
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


def part_tables(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """(model index, model label) of each task label, from the configuration's
    `part_to_task` tables (one model: the identity, model 0)."""
    models = cfg["models"]
    if len(models) == 1:
        n = int(models[0]["num_classes"])
        kpart = np.zeros(n, np.int64)
        kpart[0] = -1
        return kpart, np.arange(n, dtype=np.int64)
    n = 1 + max(max(m["part_to_task"]) for m in models)
    kpart = np.full(n, -2, np.int64)   # -2: no such label
    plab = np.zeros(n, np.int64)
    kpart[0] = -1
    for k, m in enumerate(models):
        for pl, tl in enumerate(m["part_to_task"]):
            if pl:
                kpart[tl], plab[tl] = k, pl
    return kpart, plab


class Judge:
    """Accumulates the comparison of one study's written labels."""

    def __init__(self, labels: np.ndarray, geom: StudyGeometry, cfg: dict, device):
        x0, x1, y0, y1 = geom.box
        lab = torch.from_numpy(np.ascontiguousarray(labels)).to(device).long()
        inside = torch.zeros(lab.shape, dtype=torch.bool, device=device)
        inside[x0:x1, y0:y1] = True
        kpart, plab = part_tables(cfg)
        self.outside_nonzero = int(((lab != 0) & ~inside).sum())
        canon = geo.apply_orientation(lab[x0:x1, y0:y1], geom.ornt).contiguous()
        n = len(kpart)
        self.bad_labels = int(((canon < 0) | (canon >= n)).sum())
        canon = canon.clamp(0, n - 1)
        self.kpart = torch.from_numpy(kpart).to(device)[canon]
        self.plab = torch.from_numpy(plab).to(device)[canon]
        self.bad_labels += int((self.kpart == -2).sum())
        self.gap = torch.zeros(canon.shape, dtype=torch.float32, device=device)
        self.geom = geom

    def add_model(self, k: int, logits: torch.Tensor, slab: int = 16) -> None:
        """Fold in sub-model k's reference logits (classes, model grid)."""
        ix, iy, iz = self.geom.index
        best = logits.amax(dim=0)
        for a in range(0, self.gap.shape[0], slab):
            sl = slice(a, a + slab)
            kp, pl = self.kpart[sl], self.plab[sl]
            said = torch.where(kp == k, pl, torch.zeros_like(pl))
            bound = (kp <= k) & (kp != -2)
            rows = ix[sl]
            lg = logits[:, rows][:, :, iy][:, :, :, iz]
            chosen = torch.gather(lg, 0, said[None]).squeeze(0)
            b = best[rows][:, iy][:, :, iz]
            g = torch.where(bound, b - chosen, torch.zeros_like(chosen))
            self.gap[sl] = torch.maximum(self.gap[sl], g)

    def readings(self) -> dict:
        return {"gap": self.gap.flatten(), "label_faults": self.outside_nonzero + self.bad_labels}


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


def written_labels(geom: StudyGeometry, labels_model: torch.Tensor) -> np.ndarray:
    """What the program would write for model-grid labels: the order-0
    back-resample, the inverse orientation and the pad-back, on the input grid."""
    ix, iy, iz = geom.index
    canon = labels_model[ix][:, iy][:, :, iz]
    inv = np.zeros_like(geom.ornt)
    for i in range(3):
        inv[int(geom.ornt[i, 0]), 0] = i
        inv[int(geom.ornt[i, 0]), 1] = geom.ornt[i, 1]
    crop = geo.apply_orientation(canon, inv).cpu().numpy()
    out = np.zeros(geom.orig_shape, np.uint8)
    x0, x1, y0, y1 = geom.box
    out[x0:x1, y0:y1] = crop
    return out


def merged_labels(cfg: dict, per_model: list) -> torch.Tensor:
    """Task labels on the model grid from each sub-model's argmax labels,
    later sub-models over earlier ones (one model: its labels)."""
    models = cfg["models"]
    if len(models) == 1:
        return per_model[0]
    out = torch.zeros_like(per_model[0])
    for m, lab in zip(models, per_model):
        lut = torch.tensor(m["part_to_task"], device=lab.device)
        out = torch.where(lab > 0, lut[lab], out)
    return out
