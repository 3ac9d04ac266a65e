"""Phantom CTs of the traffic mixes.

A frozen copy of `boa_tpu_torch/testing/anatomy.py:synth_ct` (geometry,
structures and HU values): an abdomen-thorax torso in physical mm, so one
definition gives a consistent phantom at any grid shape and spacing. Only
the noise depends on the seed. The volume is held in Fortran order, NIfTI's
voxel order, so that writing it is one copy; the noise is drawn in that
order too (the original draws it in C order: the same distribution, other
values).
"""

from __future__ import annotations

import numpy as np

# (center as fractions of the body half-axes x, y and of the scan length z;
#  radii in mm, z None = full-length cylinder; HU)
_ORGANS = [
    ((-0.45, -0.05, 0.33), (70.0, 55.0, 80.0), 60.0),      # liver
    ((0.35, -0.25, 0.38), (40.0, 30.0, 50.0), 30.0),       # stomach
    ((0.62, 0.1, 0.40), (35.0, 30.0, 45.0), 55.0),         # spleen
    ((-0.5, 0.42, 0.28), (25.0, 25.0, 45.0), 35.0),        # kidney right
    ((0.5, 0.42, 0.28), (25.0, 25.0, 45.0), 35.0),         # kidney left
    ((0.12, 0.08, 0.36), (45.0, 15.0, 18.0), 45.0),        # pancreas
    ((-0.25, -0.2, 0.30), (15.0, 15.0, 25.0), 20.0),       # gallbladder
    ((0.0, -0.1, 0.05), (30.0, 28.0, 30.0), 15.0),         # urinary bladder
    ((0.1, -0.25, 0.18), (55.0, 35.0, 55.0), 25.0),        # small bowel
    ((-0.15, -0.35, 0.15), (65.0, 25.0, 60.0), 10.0),      # colon
    ((0.08, -0.15, 0.72), (50.0, 45.0, 55.0), 45.0),       # heart
    ((-0.45, 0.0, 0.85), (45.0, 55.0, 75.0), -800.0),      # lung lobes
    ((-0.5, -0.3, 0.68), (35.0, 30.0, 45.0), -800.0),
    ((-0.45, 0.25, 0.62), (40.0, 40.0, 55.0), -800.0),
    ((0.5, 0.0, 0.85), (42.0, 52.0, 72.0), -800.0),
    ((0.48, 0.25, 0.62), (38.0, 38.0, 52.0), -800.0),
    ((0.02, 0.18, 0.75), (7.0, 7.0, 90.0), 30.0),          # esophagus
    ((0.09, 0.28, 0.45), (11.0, 11.0, None), 180.0),       # aorta
    ((-0.09, 0.28, 0.4), (10.0, 10.0, None), 110.0),       # inferior vena cava
    ((-0.15, 0.05, 0.36), (8.0, 8.0, 40.0), 130.0),        # portal and splenic vein
    ((-0.16, 0.62, 0.4), (18.0, 14.0, None), 50.0),        # autochthon right
    ((0.16, 0.62, 0.4), (18.0, 14.0, None), 50.0),         # autochthon left
    ((0.0, -0.8, 0.75), (15.0, 9.0, 80.0), 400.0),         # sternum
]
_N_VERTEBRAE = 17
_VERT_RADIUS = 18.0
_VERT_HEIGHT = 22.0


def _geometry(shape, spacing):
    x = (np.arange(shape[0], dtype=np.float32) - shape[0] / 2) * spacing[0]
    y = (np.arange(shape[1], dtype=np.float32) - shape[1] / 2) * spacing[1]
    z = np.arange(shape[2], dtype=np.float32) * spacing[2]
    return x, y, z, 0.62 * shape[0] / 2 * spacing[0], 0.52 * shape[1] / 2 * spacing[1]


def _paint_ellipsoid(vol, x, y, z, c, r, value):
    (cx, cy, cz), (rx, ry, rz) = c, r
    xs = np.searchsorted(x, [cx - rx, cx + rx])
    ys = np.searchsorted(y, [cy - ry, cy + ry])
    zs = np.searchsorted(z, [cz - rz, cz + rz])
    xsl = slice(max(xs[0] - 1, 0), xs[1] + 1)
    ysl = slice(max(ys[0] - 1, 0), ys[1] + 1)
    zsl = slice(max(zs[0] - 1, 0), zs[1] + 1)
    d2 = (((x[xsl] - cx) / rx) ** 2)[:, None, None] \
        + (((y[ysl] - cy) / ry) ** 2)[None, :, None] \
        + (((z[zsl] - cz) / rz) ** 2)[None, None, :]
    vol[xsl, ysl, zsl][d2 <= 1.0] = value


def synth_ct(shape, spacing, noise_hu: float, seed: int) -> np.ndarray:
    """Anatomy-shaped int16 HU volume; the noise N(0, noise_hu) from `seed`."""
    x, y, z, bx, by = _geometry(shape, spacing)
    z_len = shape[2] * spacing[2]
    r2 = (x[:, None] / bx) ** 2 + (y[None, :] / by) ** 2
    vol = np.full(shape, -1000.0, np.float32, order="F")
    vol[r2 <= 1.0, :] = 40.0
    vol[(r2 <= 1.0) & (r2 > 0.78), :] = -100.0
    vol[(r2 <= 0.78) & (r2 > 0.66), :] = 45.0
    for center, radii, hu in _ORGANS:
        cx, cy, cz = center[0] * bx, center[1] * by, center[2] * z_len
        if radii[2] is None:
            m2 = (((x - cx) / radii[0]) ** 2)[:, None] \
                + (((y - cy) / radii[1]) ** 2)[None, :] <= 1.0
            vol[m2, :] = hu
        else:
            _paint_ellipsoid(vol, x, y, z, (cx, cy, cz), radii, hu)
    for i in range(_N_VERTEBRAE):
        vz = (0.04 + i * 0.92 / _N_VERTEBRAE) * z_len + _VERT_HEIGHT / 2
        _paint_ellipsoid(vol, x, y, z, (0.0, 0.62 * by, vz),
                         (_VERT_RADIUS * 1.2, _VERT_RADIUS * 1.2, _VERT_HEIGHT / 2 * 1.4),
                         400.0)
    noise = np.random.default_rng(seed).standard_normal(shape[::-1], dtype=np.float32).T
    vol += noise_hu * noise
    return np.clip(vol, -1024, 3071, out=vol).astype(np.int16, order="F")
