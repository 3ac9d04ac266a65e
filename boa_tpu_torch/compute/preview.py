"""Segmentation preview montage: shaded surface panels per ROI group.

Counterpart of `boa_tpu/compute/preview.py` (TotalSegmentator
`preview.py:308-366`, which renders smoothed 3-D organ contours over a
sagittal CT slab with VTK). Per ROI group, the first-hit front along the
sagittal ray and the label it hits come from one pass over the label map on
the card (`_group_fronts_device`; `_label_depths` with
`_group_fronts_from_depths` is its plain host version, for the tests).
The fronts are Lambert-shaded from their smoothed depth field
(`_shade_group`, numpy and scipy) and composited per group over the CT's
sagittal MIP slab with the port's own rasterizer (`render/`), written as
PNG.
"""

from __future__ import annotations

import logging
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.render import raster
from boa_tpu_torch.render.colors import TURBO, cmap
from boa_tpu_torch.utils.timing import Spans

logger = logging.getLogger(__name__)

# ROI grouping mirrors preview.py's subject plots: organs / vertebrae /
# cardiac+vessels / muscles / ribs
ROI_GROUPS = {
    "organs": ["spleen", "kidney_right", "kidney_left", "liver", "stomach",
               "pancreas", "lung_upper_lobe_left", "lung_lower_lobe_left",
               "lung_upper_lobe_right", "lung_middle_lobe_right",
               "lung_lower_lobe_right", "esophagus", "trachea", "thyroid_gland",
               "small_bowel", "duodenum", "colon", "urinary_bladder",
               "gallbladder", "adrenal_gland_right", "adrenal_gland_left"],
    "vertebrae": [f"vertebrae_{v}" for v in
                  ["C1", "C2", "C3", "C4", "C5", "C6", "C7",
                   "T1", "T2", "T3", "T4", "T5", "T6", "T7", "T8", "T9",
                   "T10", "T11", "T12",
                   "L1", "L2", "L3", "L4", "L5", "S1"]] + ["sacrum"],
    "cardiac": ["heart", "aorta", "pulmonary_vein", "brachiocephalic_trunk",
                "subclavian_artery_right", "subclavian_artery_left",
                "common_carotid_artery_right", "common_carotid_artery_left",
                "brachiocephalic_vein_left", "brachiocephalic_vein_right",
                "atrial_appendage_left", "superior_vena_cava",
                "inferior_vena_cava", "portal_vein_and_splenic_vein",
                "iliac_artery_left", "iliac_artery_right",
                "iliac_vena_left", "iliac_vena_right"],
    "muscles": ["humerus_left", "humerus_right", "scapula_left", "scapula_right",
                "clavicula_left", "clavicula_right", "femur_left", "femur_right",
                "hip_left", "hip_right", "spinal_cord",
                "gluteus_maximus_left", "gluteus_maximus_right",
                "gluteus_medius_left", "gluteus_medius_right",
                "gluteus_minimus_left", "gluteus_minimus_right",
                "autochthon_left", "autochthon_right",
                "iliopsoas_left", "iliopsoas_right", "brain", "skull"],
    "ribs": [f"rib_{s}_{i}" for s in ("left", "right") for i in range(1, 13)]
            + ["sternum", "costal_cartilages"],
}

_FAR = np.int32(2 ** 30)     # "no surface along this ray"
_FAR16 = np.int16(32000)     # int16 "no hit" sentinel of the device maps
_BIG = 2 ** 24               # "not in this group" in the front encoding

# the montage: matplotlib's figsize (3.2 n, 6) in at 110 dpi, black
_PANEL_W, _HEIGHT = 352, 660
_PAD, _TITLE_SCALE = 16, 2


def _label_depths(seg: np.ndarray, n_labels: int) -> np.ndarray:
    """(y, z, label) first-hit x index of every label along the sagittal
    ray, _FAR where absent: one combined-key scatter-min pass."""
    nx, ny, nz = seg.shape
    width = max(n_labels, int(seg.max()) + 1)
    dt = np.int32 if ny * nz * width < 2 ** 31 else np.int64
    depth = np.full(ny * nz * width, _FAR, np.int32)
    yz = np.arange(ny * nz, dtype=dt).reshape(ny, nz)
    keys = (yz[None] * dt(width) + seg.astype(dt)).ravel()
    xvals = np.broadcast_to(
        np.arange(nx, dtype=np.int32)[:, None, None], seg.shape).ravel()
    np.minimum.at(depth, keys, xvals)
    return depth.reshape(ny, nz, width)[:, :, :n_labels]


def _group_fronts_from_depths(depths: np.ndarray, inv: dict[str, int]
                              ) -> dict[str, tuple | None]:
    """Per group (front float32, inf where no hit; which uint8 index into
    the group's label list; labels) from the full per-label depth stack."""
    out: dict[str, tuple | None] = {}
    for group, rois in ROI_GROUPS.items():
        labels = [inv[r] for r in rois if r in inv]
        if not labels:
            out[group] = None
            continue
        stack = depths[:, :, labels].astype(np.float32)
        front = stack.min(axis=2)
        which = stack.argmin(axis=2).astype(np.uint8)
        front[front >= float(_FAR)] = np.inf
        out[group] = (front, which, labels)
    return out


def _group_fronts_device(seg_dev: torch.Tensor, inv: dict[str, int], n_labels: int
                         ) -> dict[str, tuple | None]:
    """`_group_fronts_from_depths`' result from one pass per group over the
    label map on its device: per group, the min over x of `x * 256 + rank`
    (rank: the label's index in the group, from a 256-entry table gathered
    once, _BIG for labels outside the group) gives the first hit in the
    high bits and its label's rank in the low byte. Only an int16 front and
    a uint8 rank map per group come back to the host."""
    group_labels = {g: [inv[r] for r in rois if r in inv] for g, rois in ROI_GROUPS.items()}
    groups = [v for v in group_labels.values() if v]
    dev = seg_dev.device
    nx = seg_dev.shape[0]
    width = max(n_labels, 256 if seg_dev.dtype == torch.uint8 else int(seg_dev.max()) + 1)
    idx = seg_dev.reshape(-1).to(torch.int32)
    x_enc = (torch.arange(nx, dtype=torch.int32, device=dev) * 256).view(nx, 1, 1)
    fronts, whichs = [], []
    for labels in groups:
        lut = torch.full((width,), _BIG, dtype=torch.int32)
        lut[labels] = torch.arange(len(labels), dtype=torch.int32)
        rank = lut.to(dev).index_select(0, idx).view(seg_dev.shape)
        enc = torch.amin(rank + x_enc, dim=0)   # outside the group: >= _BIG
        fronts.append(torch.where(enc < _BIG, enc >> 8, int(_FAR16)).to(torch.int16))
        whichs.append((enc & 255).to(torch.uint8))
    if not groups:
        return {g: None for g in ROI_GROUPS}
    fr_all = torch.stack(fronts).cpu().numpy().astype(np.float32)
    wh_all = torch.stack(whichs).cpu().numpy()
    out: dict[str, tuple | None] = {}
    gi = 0
    for group, labels in group_labels.items():
        if not labels:
            out[group] = None
            continue
        front = fr_all[gi]
        front[front >= float(_FAR16)] = np.inf
        out[group] = (front, wh_all[gi], labels)
        gi += 1
    return out


def _shade_group(front: np.ndarray, which: np.ndarray,
                 colors: np.ndarray, aspect: float) -> np.ndarray:
    """RGBA overlay (z, y, 4) for one group from its front-surface map.

    `front` is (y, z) float32 (inf = no surface on this ray); `which`
    picks the group color; Lambert shading from the smoothed depth
    field's normals plus a depth cue gives the 3-D look."""
    from scipy import ndimage as ndi

    hit = np.isfinite(front)
    overlay = np.zeros((front.shape[1], front.shape[0], 4), np.float32)
    if not hit.any():
        return overlay

    # smooth the depth field for stable normals (organ surfaces are
    # voxelized); absent pixels get behind-everything depth so borders
    # face outward
    d = np.where(hit, front, float(front[hit].max()) + 8.0)
    d_s = ndi.gaussian_filter(d, sigma=1.6)
    gy, gz = np.gradient(d_s)
    gz = gz / max(aspect, 1e-3)  # physical-aspect correction
    # surface normal of x = d(y,z): (-1, gy, gz) (towards the viewer)
    norm = np.sqrt(1.0 + gy * gy + gz * gz)
    light = np.array([-1.0, -0.35, 0.45])
    light = light / np.linalg.norm(light)
    lambert = (-light[0] - light[1] * gy - light[2] * gz) / norm
    shade = np.clip(lambert, 0.15, 1.0)
    # depth cue: deeper surfaces slightly darker
    dr = front[hit]
    lo, hi = float(dr.min()), float(np.percentile(dr, 95) + 1.0)
    cue = 1.0 - 0.3 * np.clip((front - lo) / max(hi - lo, 1.0), 0.0, 1.0)
    intensity = shade * cue

    rgb = colors[which]  # (y, z, 3)
    out = rgb * intensity[..., None]
    overlay[..., :3] = np.transpose(out, (1, 0, 2))
    overlay[..., 3] = np.where(hit, 0.95, 0.0).T
    return overlay


def generate_preview(ct_img, seg_img, label_map: dict[int, str], out_path: str | Path,
                     aspect: float | None = None, worker=None, device=None,
                     spans: dict | None = None):
    """Render the montage to `out_path`. The fronts come from the label
    map's copy on `device` (default: the card; `seg_img.device_data`, so
    the copy that `compute_all_models` cached is used), on this thread;
    there is no host fallback. With a `worker` (utils/stages.HostWorker)
    the shading and drawing run there, and a failure there is logged, not
    raised; the Future is returned. `spans`, when given, receives
    `preview_fronts` (this thread) and `preview_render` (the drawing)."""
    device = resolve_device(device)
    sp = Spans(spans, device)
    ct = np.asarray(ct_img.data)
    if tuple(seg_img.shape) != ct.shape:
        ct = None  # differently-gridded: skip the CT underlay
    inv = {v: k for k, v in label_map.items()}
    if aspect is None:
        zooms = getattr(ct_img, "zooms", (1.0, 1.0, 1.0))
        aspect = zooms[2] / zooms[1]
    n_labels = int(max(inv.values(), default=0)) + 1
    group_fronts = _group_fronts_device(seg_img.device_data(device), inv, n_labels)
    sp.mark("preview_fronts")
    if worker is not None:
        return worker.submit("preview-render", _render_timed, ct, group_fronts, aspect,
                             out_path, spans, suppress=True)
    _render_timed(ct, group_fronts, aspect, out_path, spans)
    return None


def _render_timed(ct, group_fronts, aspect, out_path, spans: dict | None) -> None:
    t0 = perf_counter()
    _render_montage(ct, group_fronts, aspect, out_path)
    if spans is not None:   # a key only this stage writes
        spans["preview_render"] = spans.get("preview_render", 0) + perf_counter() - t0


def _render_montage(ct: np.ndarray | None, group_fronts: dict[str, tuple | None],
                    aspect: float, out_path: str | Path) -> None:
    """Host only: one black panel per ROI group with its name, the CT's
    sagittal MIP slab in gray (origin lower, `aspect`) and the group's
    shaded overlay at alpha 0.95 over it."""
    canvas = raster.Canvas(_PANEL_W * len(ROI_GROUPS), _HEIGHT, "#000000")
    slab = None
    if ct is not None:
        # one sagittal MIP slab shared by every panel
        mid = ct.shape[0] // 2
        slab = np.clip(ct[max(0, mid - 10):mid + 10].max(axis=0), -200, 500).T
    title_h = 10 * _TITLE_SCALE + 12
    for i, group in enumerate(ROI_GROUPS):
        box = (i * _PANEL_W + _PAD / 2, _PAD + title_h, _PANEL_W - _PAD, _HEIGHT - 2 * _PAD - title_h)
        entry = group_fronts.get(group)
        overlay = None
        if entry is not None:
            front, which, labels = entry
            colors = np.asarray([cmap(TURBO, k / max(len(labels) - 1, 1))
                                 for k in range(len(labels))], np.float32)
            overlay = _shade_group(front, which, colors, aspect)
        shape = slab.shape if slab is not None else overlay.shape[:2] if overlay is not None else None
        top = box[1]
        if shape is not None:
            rect = raster.image_rect(box, *shape, aspect=aspect)
            top = rect[1]
            if slab is not None:
                canvas.blit(raster.gray(slab), rect, origin="lower")
            if overlay is not None and overlay[..., 3].any():
                canvas.blit(overlay, rect, origin="lower")
        canvas.text(group, i * _PANEL_W + _PANEL_W / 2, top - title_h + 4, "#ffffff",
                    scale=_TITLE_SCALE)
    canvas.save_png(out_path)
    logger.info("Preview saved to %s", out_path)
