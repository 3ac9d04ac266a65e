"""Synthetic-anatomy phantom: a CT volume plus matching segmentations.

Counterpart of `boa_tpu/testing/anatomy.py`, numpy only; on the same
arguments both paint identical volumes. Organs are geometric solids placed
in physical (mm) coordinates, so one phantom definition gives consistent CT
HU values, TotalSegmentator labels and BCA region and part labels at any
grid shape and spacing: what the reference's `test=N` fake-inference hook
substitutes committed segmentations for, generated here instead of shipped.

Each structure is painted inside its own bounding box, so a full
512×512×300 phantom takes about a second.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from boa_tpu_torch.bca.definitions import BodyPart, BodyRegion
from boa_tpu_torch.tasks.class_maps import get_class_map


@dataclass(frozen=True)
class _Ellipsoid:
    name: str          # total class-map name
    center: tuple      # fractions of (body_x, body_y, z_extent)
    radii: tuple       # mm (x, y, z); z=None → full-length cylinder
    hu: float


# centers are fractions of the body ellipse half-axes (x, y) and of the
# scan length (z: 0 feet .. 1 head; the phantom is an abdomen+thorax
# torso). Later entries overwrite earlier ones where they overlap.
_ORGANS = [
    _Ellipsoid("liver", (-0.45, -0.05, 0.33), (70.0, 55.0, 80.0), 60.0),
    _Ellipsoid("stomach", (0.35, -0.25, 0.38), (40.0, 30.0, 50.0), 30.0),
    _Ellipsoid("spleen", (0.62, 0.1, 0.40), (35.0, 30.0, 45.0), 55.0),
    _Ellipsoid("kidney_right", (-0.5, 0.42, 0.28), (25.0, 25.0, 45.0), 35.0),
    _Ellipsoid("kidney_left", (0.5, 0.42, 0.28), (25.0, 25.0, 45.0), 35.0),
    _Ellipsoid("pancreas", (0.12, 0.08, 0.36), (45.0, 15.0, 18.0), 45.0),
    _Ellipsoid("gallbladder", (-0.25, -0.2, 0.30), (15.0, 15.0, 25.0), 20.0),
    _Ellipsoid("urinary_bladder", (0.0, -0.1, 0.05), (30.0, 28.0, 30.0),
               15.0),
    _Ellipsoid("small_bowel", (0.1, -0.25, 0.18), (55.0, 35.0, 55.0), 25.0),
    _Ellipsoid("colon", (-0.15, -0.35, 0.15), (65.0, 25.0, 60.0), 10.0),
    _Ellipsoid("heart", (0.08, -0.15, 0.72), (50.0, 45.0, 55.0), 45.0),
    _Ellipsoid("lung_upper_lobe_right", (-0.45, 0.0, 0.85),
               (45.0, 55.0, 75.0), -800.0),
    _Ellipsoid("lung_middle_lobe_right", (-0.5, -0.3, 0.68),
               (35.0, 30.0, 45.0), -800.0),
    _Ellipsoid("lung_lower_lobe_right", (-0.45, 0.25, 0.62),
               (40.0, 40.0, 55.0), -800.0),
    _Ellipsoid("lung_upper_lobe_left", (0.5, 0.0, 0.85),
               (42.0, 52.0, 72.0), -800.0),
    _Ellipsoid("lung_lower_lobe_left", (0.48, 0.25, 0.62),
               (38.0, 38.0, 52.0), -800.0),
    _Ellipsoid("esophagus", (0.02, 0.18, 0.75), (7.0, 7.0, 90.0), 30.0),
    # vessels: full-height cylinders (z radius None)
    _Ellipsoid("aorta", (0.09, 0.28, 0.45), (11.0, 11.0, None), 180.0),
    _Ellipsoid("inferior_vena_cava", (-0.09, 0.28, 0.4),
               (10.0, 10.0, None), 110.0),
    _Ellipsoid("portal_vein_and_splenic_vein", (-0.15, 0.05, 0.36),
               (8.0, 8.0, 40.0), 130.0),
    # paraspinal muscles (CNR reference) as tall cylinders
    _Ellipsoid("autochthon_right", (-0.16, 0.62, 0.4),
               (18.0, 14.0, None), 50.0),
    _Ellipsoid("autochthon_left", (0.16, 0.62, 0.4),
               (18.0, 14.0, None), 50.0),
    # anterior chest wall bone: populates the preview's "ribs" ROI group
    _Ellipsoid("sternum", (0.0, -0.8, 0.75), (15.0, 9.0, 80.0), 400.0),
]

#: vertebra stack: L5 (bottom) .. T1, evenly spaced along the scan
_VERT_NAMES = ["vertebrae_L5", "vertebrae_L4", "vertebrae_L3",
               "vertebrae_L2", "vertebrae_L1", "vertebrae_T12",
               "vertebrae_T11", "vertebrae_T10", "vertebrae_T9",
               "vertebrae_T8", "vertebrae_T7", "vertebrae_T6",
               "vertebrae_T5", "vertebrae_T4", "vertebrae_T3",
               "vertebrae_T2", "vertebrae_T1"]
_VERT_RADIUS = 18.0
_VERT_HEIGHT = 22.0


def _geometry(shape, spacing):
    x = (np.arange(shape[0], dtype=np.float32) - shape[0] / 2) * spacing[0]
    y = (np.arange(shape[1], dtype=np.float32) - shape[1] / 2) * spacing[1]
    z = np.arange(shape[2], dtype=np.float32) * spacing[2]
    bx = 0.62 * shape[0] / 2 * spacing[0]
    by = 0.52 * shape[1] / 2 * spacing[1]
    return x, y, z, bx, by


def _body_rings(shape, spacing):
    """(body2d, fat2d, muscle2d) boolean in-plane masks."""
    x, y, _, bx, by = _geometry(shape, spacing)
    r2 = (x[:, None] / bx) ** 2 + (y[None, :] / by) ** 2
    return r2 <= 1.0, (r2 <= 1.0) & (r2 > 0.78), (r2 <= 0.78) & (r2 > 0.66)


def _iter_structures(shape, spacing):
    """Yields (name, hu, paint) where paint(vol_like, value) assigns the
    structure's voxels; bbox-scoped for ellipsoids, 2-D-mask-indexed for
    full-height cylinders."""
    x, y, z, bx, by = _geometry(shape, spacing)
    z_len = shape[2] * spacing[2]

    def cylinder_paint(mask2d):
        def paint(vol, value):
            vol[mask2d, :] = value
        return paint

    def ellipsoid_paint(cx, cy, cz, rx, ry, rz):
        xs = np.searchsorted(x, [cx - rx, cx + rx])
        ys = np.searchsorted(y, [cy - ry, cy + ry])
        zs = np.searchsorted(z, [cz - rz, cz + rz])
        xsl = slice(max(xs[0] - 1, 0), xs[1] + 1)
        ysl = slice(max(ys[0] - 1, 0), ys[1] + 1)
        zsl = slice(max(zs[0] - 1, 0), zs[1] + 1)
        d2 = (((x[xsl] - cx) / rx) ** 2)[:, None, None] \
            + (((y[ysl] - cy) / ry) ** 2)[None, :, None] \
            + (((z[zsl] - cz) / rz) ** 2)[None, None, :]
        mask = d2 <= 1.0

        def paint(vol, value):
            vol[xsl, ysl, zsl][mask] = value
        return paint

    for organ in _ORGANS:
        cx, cy = organ.center[0] * bx, organ.center[1] * by
        cz = organ.center[2] * z_len
        rx, ry, rz = organ.radii
        if rz is None:
            m2 = (((x - cx) / rx) ** 2)[:, None] \
                + (((y - cy) / ry) ** 2)[None, :] <= 1.0
            yield organ.name, organ.hu, cylinder_paint(m2)
        else:
            yield organ.name, organ.hu, ellipsoid_paint(cx, cy, cz,
                                                        rx, ry, rz)

    vx, vy = 0.0, 0.62 * by
    for i, vname in enumerate(_VERT_NAMES):
        vz = (0.04 + i * 0.92 / len(_VERT_NAMES)) * z_len \
            + _VERT_HEIGHT / 2
        yield vname, 400.0, ellipsoid_paint(vx, vy, vz, _VERT_RADIUS * 1.2,
                                            _VERT_RADIUS * 1.2,
                                            _VERT_HEIGHT / 2 * 1.4)


def synth_ct(shape=(512, 512, 300), spacing=(1.5, 1.5, 3.0),
             noise_hu: float = 10.0, seed: int = 0) -> np.ndarray:
    """Anatomy-shaped int16 HU volume."""
    rng = np.random.default_rng(seed)
    body2d, fat2d, muscle2d = _body_rings(shape, spacing)
    vol = np.full(shape, -1000.0, np.float32)
    vol[body2d, :] = 40.0
    vol[fat2d, :] = -100.0
    vol[muscle2d, :] = 45.0
    for _, hu, paint in _iter_structures(shape, spacing):
        paint(vol, hu)
    vol += noise_hu * rng.standard_normal(shape, dtype=np.float32)
    return np.clip(vol, -1024, 3071).astype(np.int16)


def fake_total_seg(shape, spacing) -> np.ndarray:
    """117-class `total` segmentation matching synth_ct's geometry."""
    inv = {v: k for k, v in get_class_map("total").items()}
    seg = np.zeros(shape, np.uint8)
    for name, _, paint in _iter_structures(shape, spacing):
        label = inv.get(name)
        if label is not None:
            paint(seg, label)
    return seg


def fake_regions_seg(shape, spacing) -> np.ndarray:
    """11-label BCA body_regions segmentation from the same geometry."""
    seg = np.zeros(shape, np.uint8)
    body2d, fat2d, muscle2d = _body_rings(shape, spacing)
    _, _, z, _, _ = _geometry(shape, spacing)
    z_len = shape[2] * spacing[2]
    diaphragm = int(np.searchsorted(z, 0.52 * z_len))
    seg[body2d, :diaphragm] = int(BodyRegion.ABDOMINAL_CAVITY)
    seg[body2d, diaphragm:] = int(BodyRegion.THORACIC_CAVITY)
    seg[fat2d, :] = int(BodyRegion.SUBCUTANEOUS_TISSUE)
    seg[muscle2d, :] = int(BodyRegion.MUSCLE)
    for name, _, paint in _iter_structures(shape, spacing):
        if name.startswith("vertebrae") or name == "sternum":
            paint(seg, int(BodyRegion.BONE))
        elif name in ("autochthon_left", "autochthon_right"):
            paint(seg, int(BodyRegion.MUSCLE))
        elif name == "heart":
            paint(seg, int(BodyRegion.PERICARDIUM))
        elif name == "esophagus":
            paint(seg, int(BodyRegion.MEDIASTINUM))
    return seg


def fake_parts_seg(shape, spacing) -> np.ndarray:
    """BCA body_parts: the whole phantom is TORSO."""
    seg = np.zeros(shape, np.uint8)
    body2d, _, _ = _body_rings(shape, spacing)
    seg[body2d, :] = int(BodyPart.TORSO)
    return seg


def fake_part_seg(shape, spacing, task_id: int) -> np.ndarray:
    """One 5-part sub-model's output in PART-id space (task ids 291-295).

    The multimodel pipeline LUT-remaps each sub-model's part ids into the
    total class map (inference/pipeline.py merge loop), so the fake must
    emit part-space labels — total-space ids would be misread as part ids.

    Derived as an inverse-LUT slice of `fake_total_seg` (NOT painted
    per-part): on voxels where structures of different parts overlap,
    per-part painting and the pipeline's 291→295 merge order would pick
    different winners, so slicing the total fake is the only convention
    that makes all three routes agree exactly — per-part host fakes,
    the pipeline's `total_space` single-upload path, and the fast
    single-model total.
    """
    from boa_tpu_torch.tasks import class_maps

    pm = class_maps.class_map_5_parts[class_maps.map_taskid_to_partname[task_id]]
    inv_total = {v: k for k, v in get_class_map("total").items()}
    lut = np.zeros(max(inv_total.values()) + 1, np.uint8)
    for pid, name in pm.items():
        lut[inv_total[name]] = pid
    return lut[fake_total_seg(shape, spacing)]


def fake_predict_factory():
    """fake_predict(vol, spacing, task_id) covering total + BCA tasks."""
    def fake(vol: np.ndarray, spacing, task_id: int) -> np.ndarray:
        shape = vol.shape
        if task_id == 542:
            return fake_regions_seg(shape, spacing)
        if task_id == 543:
            return fake_parts_seg(shape, spacing)
        if task_id in (291, 292, 293, 294, 295):
            return fake_part_seg(shape, spacing, task_id)
        return fake_total_seg(shape, spacing)

    fake.wants_volume = False  # shape-only: skip the volume download
    # the 5-part sub-model fakes are exact inverse-LUT slices of the total
    # fake (both paint the same structures), so the pipeline may upload
    # the total fake ONCE and split it on device (task_id -1 -> total)
    fake.total_space = True
    return fake
