"""Evans index from ventricle + brain/skull segmentations.

Counterpart of `boa_tpu/tools/evans_index.py` (TotalSegmentator
`bin/totalseg_evans_index.py`): Evans index = (max transverse diameter of
the frontal horns) / (max inner-skull transverse diameter), measured on the
slice of the maximal horn diameter (`max_diameter_x:55-79`), plus ventricle
and brain volumes and an overview image. With the CT at hand the head is
first registered to the brain atlas (`resources/ct_brain_atlas_1mm.nii.gz`)
by the port's gradient-descent registration on the card
(`ops/registration.py`); without it, or when the registration fails, the
in-plane head rotation is normalized from the brain mask's axial principal
axes (`inplane_rotation_deg`). The overview is drawn on the port's own
canvas (`render/raster.py`) and written by `render/png.py`.

    python -m boa_tpu_torch.tools.evans_index -i head.nii.gz -o evans.json -p evans.png
    ... -d cpu      # on the host; the default is the card (-d gpu)
"""

from __future__ import annotations

import argparse
import json
import logging
import math
from pathlib import Path

import numpy as np

from boa_tpu_torch.device import named_device, resolve_device
from boa_tpu_torch.ops.connected_components import (filter_components_by_size,
                                                    largest_component)

logger = logging.getLogger(__name__)

FRONTAL_HORN_LABELS = ("frontal_horn_left", "frontal_horn_right")


def inner_skull_cavity(brain_mask: np.ndarray,
                       skull_mask: np.ndarray | None) -> np.ndarray:
    """Inner-skull cavity: brain dilated 2 iterations (to fill the
    brain-CSF gap), skull voxels removed, largest blob
    (`totalseg_evans_index.py:246-252`). Without a skull mask the raw
    brain is returned: unconstrained dilation would overestimate the
    transverse diameter."""
    if skull_mask is None or not skull_mask.any():
        return brain_mask
    from scipy import ndimage

    cavity = ndimage.binary_dilation(brain_mask, iterations=2)
    cavity[skull_mask > 0] = 0
    return largest_component(cavity).astype(bool)


def inplane_rotation_deg(brain_mask: np.ndarray, spacing=(1.0, 1.0)) -> float:
    """In-plane head rotation from the brain mask's axial second moments.

    The head's anterior-posterior extent is the major axis of the axial
    (x, y) point cloud, so the measurement frame rotates it onto +y.
    Returns degrees in (-45, 45]; a larger estimate (a silhouette wider than
    long) is distrusted and gives 0."""
    idx = np.argwhere(brain_mask)
    if len(idx) < 16:
        return 0.0
    xy = idx[:, :2].astype(np.float64) * np.asarray(spacing[:2])  # mm space
    xy -= xy.mean(axis=0)
    cov = xy.T @ xy / len(xy)
    evals, evecs = np.linalg.eigh(cov)
    major = evecs[:, int(np.argmax(evals))]  # (x, y) of the AP axis
    ang = math.degrees(math.atan2(-major[0], major[1]))  # 0 when AP == +y
    if ang > 90:
        ang -= 180
    elif ang <= -90:
        ang += 180
    return float(ang) if abs(ang) <= 45.0 else 0.0


def _rotate_masks_inplane(deg: float, *masks: np.ndarray):
    """Order-0 in-plane rotation about the volume centre (scipy, once per
    study). The grid is padded to the in-plane diagonal first, so an
    off-centre head is never clipped at the edge by the reshape=False
    rotation (the diameters downstream are translation-invariant)."""
    from scipy import ndimage as ndi

    x, y = masks[0].shape[:2]
    diag = int(np.ceil(np.hypot(x, y)))
    px = (diag - x) // 2 + 1
    py = (diag - y) // 2 + 1
    out = []
    for m in masks:
        mp = np.pad(m.astype(np.uint8), ((px, px), (py, py), (0, 0)))
        out.append(ndi.rotate(mp, deg, axes=(1, 0), reshape=False, order=0,
                              prefilter=False) > 0)
    return tuple(out)


def max_diameter_x(mask: np.ndarray):
    """((diameter_vox, (start, end))) over all z slices: the exact
    `totalseg_evans_index.py:55-79` scan."""
    best = (0, ([0, 0, 0], [0, 0, 0]))
    for z in range(mask.shape[2]):
        sl = mask[:, :, z]
        for y in range(sl.shape[1]):
            x_idx = np.where(sl[:, y])[0]
            if len(x_idx):
                d = int(x_idx[-1] - x_idx[0])
                if d > best[0]:
                    best = (d, ([int(x_idx[0]), y, z], [int(x_idx[-1]), y, z]))
    return best


_ATLAS_PATH = (Path(__file__).resolve().parents[1] / "resources" /
               "ct_brain_atlas_1mm.nii.gz")


def align_to_atlas(ct: np.ndarray, spacing, masks: list[np.ndarray],
                   atlas_data: np.ndarray | None = None,
                   atlas_spacing: float = 1.0,
                   levels=(4, 2), steps_per_level: int = 150,
                   device=None) -> tuple[list[np.ndarray], dict]:
    """Affine-register the head CT to the brain atlas on `device` (the card
    by default) and warp the masks into atlas space.

    Returns (warped_masks, info); the atlas ships with the package."""
    from scipy import ndimage as ndi

    from boa_tpu_torch.ops.registration import register_affine, warp_labels

    if atlas_data is None:
        from boa_tpu_torch.io import nifti

        atlas_data = np.asarray(nifti.load(_ATLAS_PATH).data)
    # patient volume to the atlas voxel size (order-1 CT, order-0 masks)
    zoom = tuple(float(s) / atlas_spacing for s in spacing)
    ct_iso = ndi.zoom(np.asarray(ct, np.float32), zoom, order=1)
    masks_iso = [ndi.zoom(m.astype(np.uint8), zoom, order=0) for m in masks]
    # the brain soft-tissue window drives the similarity
    fixed = np.clip(np.asarray(atlas_data, np.float32), 0.0, 100.0)
    moving = np.clip(ct_iso, 0.0, 100.0)
    params, matrix, ncc = register_affine(fixed, moving, levels=levels,
                                          steps_per_level=steps_per_level,
                                          device=device)
    warped = [warp_labels(m, matrix, fixed.shape, device=device) for m in masks_iso]
    info = {"ncc": round(float(ncc), 4),
            "rotation_deg": [round(float(np.degrees(r)), 2)
                             for r in np.asarray(params.rotation)],
            "translation_vox": [round(float(t), 2)
                                for t in np.asarray(params.translation)]}
    return warped, info


def evans_index(ventricle_seg: np.ndarray,
                ventricle_label_map: dict[int, str],
                brain_mask: np.ndarray,
                spacing, plot_file: str | Path | None = None,
                ct: np.ndarray | None = None,
                atlas_data: np.ndarray | None = None,
                atlas_spacing: float = 1.0,
                registration_steps: int = 150,
                skull_mask: np.ndarray | None = None,
                device=None) -> dict:
    """The Evans index and volumes; with `ct`, measured in atlas space after
    the registration on `device` (the card by default, resolved before the
    registration so a missing card raises and is never taken for a failed
    registration)."""
    inv = {v: k for k, v in ventricle_label_map.items()}
    horns = np.isin(ventricle_seg, [inv[n] for n in FRONTAL_HORN_LABELS if n in inv])
    if not horns.any() or not brain_mask.any():
        return {"success": False, "reason": "empty ventricle or brain segmentation"}
    # volumes come from the UNROTATED masks; brain volume = inner-skull
    # cavity, like the reference (`:252-256`)
    ml_per_voxel = float(np.prod(spacing)) / 1000.0
    vent_vol = float((ventricle_seg > 0).sum()) * ml_per_voxel
    brain_vol = float(inner_skull_cavity(brain_mask, skull_mask).sum()) * ml_per_voxel

    # preferred path: the atlas registration; the in-plane moment alignment
    # below is the CT-less fallback
    measure_spacing = float(spacing[0])
    rot_deg = 0.0
    atlas_info = None
    warp_masks = [horns, brain_mask] + ([skull_mask] if skull_mask is not None else [])
    if ct is not None:
        device = resolve_device(device)
        try:
            aligned = align_to_atlas(ct, spacing, warp_masks, atlas_data=atlas_data,
                                     atlas_spacing=atlas_spacing,
                                     steps_per_level=registration_steps, device=device)
        except Exception:
            logger.exception("atlas registration failed; falling back")
            aligned = None
        if aligned is not None and aligned[1]["ncc"] >= 0.5 \
                and aligned[0][0].any() and aligned[0][1].any():
            warped, atlas_info = aligned
            horns, brain_mask = warped[0], warped[1]
            if skull_mask is not None:
                skull_mask = warped[2]
            measure_spacing = atlas_spacing
            rot_deg = float(atlas_info["rotation_deg"][2])
    if atlas_info is None:
        # index-space rotation shears physical shapes when in-plane spacing
        # is anisotropic: only align when the axial pixels are square to ~2%
        iso_inplane = abs(spacing[0] - spacing[1]) <= 0.02 * max(spacing[0], spacing[1])
        rot_deg = inplane_rotation_deg(brain_mask, spacing) if iso_inplane else 0.0
        if abs(rot_deg) > 1.0:  # measure in the head-aligned frame
            rotated = _rotate_masks_inplane(
                -rot_deg, horns, brain_mask,
                *([skull_mask] if skull_mask is not None else []))
            horns, brain_mask = rotated[0], rotated[1]
            if skull_mask is not None:
                skull_mask = rotated[2]
    # diameters measure the inner-skull cavity in the aligned frame
    # (`:246-266`: dilate 2 -> remove skull -> largest blob -> small-blob
    # filters -> max_diameter_x at the horn slice)
    cavity = inner_skull_cavity(brain_mask, skull_mask)
    # the reference removes blobs < 200 / < 10 voxels in its 1 mm atlas
    # space (= mm^3); converted to this grid's voxel volume; (lo, hi]
    vox_mm3 = atlas_spacing ** 3 if atlas_info is not None else float(np.prod(spacing))
    cavity = filter_components_by_size(cavity, (200.0 / vox_mm3 - 1, 1e10)).astype(bool)
    horns = filter_components_by_size(horns, (10.0 / vox_mm3 - 1, 1e10)).astype(bool)
    if not horns.any() or not cavity.any():
        return {"success": False, "reason": "empty masks after postprocessing"}
    d_v, (start_v, end_v) = max_diameter_x(horns)
    z = start_v[2]
    # brain diameter on the same slice (the reference measures at the horn slice)
    d_b, (start_b, end_b) = max_diameter_x(cavity[:, :, z:z + 1])
    start_b[2] = end_b[2] = z
    if d_b == 0:
        return {"success": False, "reason": "no brain on horn slice"}
    ei = d_v / d_b
    result = {
        "success": True,
        "evans_index": round(float(ei), 4),
        "ventricle_diameter_mm": round(d_v * measure_spacing, 2),
        "brain_diameter_mm": round(d_b * measure_spacing, 2),
        "ventricle_volume_ml": round(vent_vol, 1),
        "brain_volume_ml": round(brain_vol, 1),
        "ventricle_brain_ratio": round(vent_vol / max(brain_vol, 1e-6), 4),
        "slice": int(z),
        "inplane_rotation_deg": round(rot_deg, 2),
    }
    if atlas_info is not None:
        result["atlas_registration"] = atlas_info
    if plot_file is not None:
        _plot(cavity, start_b, end_b, start_v, end_v, result, plot_file)
    return result


def _plot(brain, start_b, end_b, start_v, end_v, result, out) -> None:
    """The reference's overview (`:265-287`) on the port's canvas: the
    cavity slice at the horn slice in gray, y up and x mirrored (imshow's
    origin="lower" with an inverted x axis), both diameters as green lines
    with red crosses at their ends, the four-line title above."""
    from boa_tpu_torch.render.raster import Canvas, gray

    z = start_v[2]
    sl = brain[:, :, z].T                      # rows y, columns x
    rows, cols = sl.shape
    s = max(1, 600 // max(rows, cols))         # pixels per voxel
    lines = [f"EVANS INDEX: {result['evans_index']:.3f}",
             f"brain volume: {result['brain_volume_ml']:.1f}ml",
             f"ventricle volume: {result['ventricle_volume_ml']:.1f}ml",
             f"ventricle/brain ratio: {result['ventricle_brain_ratio']:.3f}"]
    line_h, top = 20, 20 * len(lines) + 12
    canvas = Canvas(cols * s, rows * s + top, "#ffffff")
    for i, text in enumerate(lines):
        canvas.text(text, canvas.width / 2, 6 + i * line_h, "#000000", scale=2)
    canvas.blit(gray(sl)[::-1, ::-1], (0, top, cols * s, rows * s))

    def px(p):   # voxel (x, y) -> canvas pixel (mirrored x, y up)
        return (cols - 1 - p[0] + 0.5) * s, (rows - 1 - p[1] + 0.5) * s + top

    for a, b in ((start_b, end_b), (start_v, end_v)):
        canvas.line(px(a), px(b), "#008000", width=max(3, s))
    r = max(6, 3 * s)
    for p in (start_b, end_b, start_v, end_v):
        x, y = px(p)
        canvas.line((x - r, y - r), (x + r, y + r), "#ff0000", width=2)
        canvas.line((x - r, y + r), (x + r, y - r), "#ff0000", width=2)
    canvas.save_png(out)


def main(argv=None, *, store=None, fake_predict=None) -> None:
    """The command. `store` (default `ModelStore()`) and `fake_predict` (the
    pipeline's test hook) are for callers in Python, not on the command
    line."""
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.weights.store import ModelStore

    ap = argparse.ArgumentParser("totalseg_evans_index")
    ap.add_argument("-i", "--input", type=Path, required=True)
    ap.add_argument("-o", "--output", type=Path, default=None)
    ap.add_argument("-p", "--plot", type=Path, default=None)
    ap.add_argument("-d", "--device", default="gpu",
                    help="gpu (the card, default), gpu:N or cpu")
    args = ap.parse_args(argv)
    device = named_device(args.device)
    img = nifti.load(args.input)
    store = store or ModelStore()
    vent = predict_image(img, "ventricle_parts", store, fake_predict=fake_predict,
                         device=device)
    total = predict_image(img, "total", store, fast=True, fake_predict=fake_predict,
                          device=device)
    inv = {v: k for k, v in total.label_map.items()}
    brain = np.asarray(total.seg.data) == inv.get("brain", -1)
    skull = np.asarray(total.seg.data) == inv.get("skull", -1)
    res = evans_index(np.asarray(vent.seg.data), vent.label_map, brain, img.zooms,
                      plot_file=args.plot, ct=np.asarray(img.data),
                      skull_mask=skull if skull.any() else None, device=device)
    print(json.dumps(res, indent=2))
    if args.output:
        args.output.write_text(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
