"""pyradiomics-style shape features for binary 3D masks, on the host.

Counterpart of `boa_tpu/measure/shape.py`: the same code, so the same
floats (the 2D hulls' monotone chain runs on each x column's extreme
points only, which leaves the hull unchanged). The `shape` feature class the reference enables through
pyradiomics (`totalsegmentator/statistics.py:16-61`, `standard_features`
shape list: Elongation, Flatness, Least/Major/MinorAxisLength,
Maximum2DDiameterColumn/Row/Slice, Maximum3DDiameter, MeshVolume,
Sphericity, SurfaceArea, SurfaceVolumeRatio, VoxelVolume), from the
published pyradiomics feature definitions, not its C code:

* Mesh features come from a marching-cubes triangulation of the 0.5
  iso-surface of the (zero-padded) binary mask. For binary data every
  edge intersection lands at the edge MIDPOINT, so the 256-configuration
  triangle table is generated at first use: per cube face, intersection
  points pair up (the diagonal-ambiguous face is resolved by pairing the
  two edges that share an inside corner — the same rule on both sides of
  a shared face, so the global surface is watertight), pairs chain into
  closed polygons, polygons are oriented outward by Newell normal vs the
  inside-corner centroid and fan-triangulated. SurfaceArea is the
  triangle-area sum; MeshVolume is the divergence-theorem
  signed-tetrahedron sum over the closed surface.
* Axis lengths use pyradiomics' definition: 4*sqrt(eigenvalue) of the
  physical-coordinate covariance of the mask voxel centers; Elongation =
  sqrt(l2/l1), Flatness = sqrt(l3/l1).
* Maximum diameters are max pairwise distances over mesh vertices,
  reduced to convex-hull vertices first (the maximum is attained there):
  3D via scipy's qhull, per-plane projections via a monotone-chain hull.

The reference runs pyradiomics on a 3 mm resampled grid
(`statistics.py:42`); these features are computed on the grid they are
given.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# marching-cubes table generation (binary masks, midpoint vertices)
# ---------------------------------------------------------------------------

# corner i at offset (i & 1, (i >> 1) & 1, (i >> 2) & 1)
_CORNERS = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
                    np.float64)
# 12 edges as corner pairs (popcount of xor == 1)
_EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8)
          if bin(a ^ b).count("1") == 1]
# 6 faces: (axis, value) -> corner set
_FACES = [frozenset(c for c in range(8) if (c >> ax) & 1 == v)
          for ax in range(3) for v in (0, 1)]


def _polygons_for_config(cfg: int) -> list[list[int]]:
    """Closed vertex cycles (as edge indices) of the iso-surface patch."""
    inside = [c for c in range(8) if (cfg >> c) & 1]
    cut = [i for i, (a, b) in enumerate(_EDGES)
           if ((cfg >> a) & 1) != ((cfg >> b) & 1)]
    if not cut:
        return []
    # per-face pairing of intersection points
    links: dict[int, list[int]] = {e: [] for e in cut}
    for face in _FACES:
        ef = [e for e in cut if set(_EDGES[e]) <= face]
        if len(ef) == 2:
            links[ef[0]].append(ef[1])
            links[ef[1]].append(ef[0])
        elif len(ef) == 4:
            # two diagonal inside corners: pair the edges sharing each one
            for ci in [c for c in inside if c in face]:
                pair = [e for e in ef if ci in _EDGES[e]]
                links[pair[0]].append(pair[1])
                links[pair[1]].append(pair[0])
    # chain pairs into cycles: every cut edge lies on exactly 2 faces and
    # gets exactly one partner per face
    assert all(len(v) == 2 for v in links.values()), (cfg, links)
    polys, seen = [], set()
    for start in cut:
        if start in seen:
            continue
        cyc, prev, cur = [start], -1, start
        seen.add(start)
        while True:
            a, b = links[cur]
            nxt = b if a == prev else a
            if nxt == start:
                break
            cyc.append(nxt)
            seen.add(nxt)
            prev, cur = cur, nxt
        polys.append(cyc)
    return polys


def _edge_mid(e: int) -> np.ndarray:
    a, b = _EDGES[e]
    return (_CORNERS[a] + _CORNERS[b]) / 2.0


def _build_tables() -> list[np.ndarray]:
    """tri[cfg] = (n_tri, 3, 3) float64 LOCAL triangle vertices, outward."""
    tables = []
    for cfg in range(256):
        tris = []
        inside = [c for c in range(8) if (cfg >> c) & 1]
        if inside and len(inside) < 8:
            for poly in _polygons_for_config(cfg):
                pts = np.array([_edge_mid(e) for e in poly])
                # orient by THIS polygon's own edge endpoints (a cell-global
                # centroid ties for e.g. two diagonally-opposite inside
                # corners and breaks watertightness)
                ins, outs = [], []
                for e in poly:
                    a, b = _EDGES[e]
                    ins.append(_CORNERS[a if (cfg >> a) & 1 else b])
                    outs.append(_CORNERS[b if (cfg >> a) & 1 else a])
                in_c = np.mean(ins, axis=0)
                out_c = np.mean(outs, axis=0)
                # Newell normal of the (possibly non-planar) cycle
                nrm = np.zeros(3)
                for i in range(len(pts)):
                    p, q = pts[i], pts[(i + 1) % len(pts)]
                    nrm += np.cross(p, q)
                if np.dot(nrm, out_c - in_c) < 0:
                    pts = pts[::-1]
                for i in range(1, len(pts) - 1):
                    tris.append([pts[0], pts[i], pts[i + 1]])
        tables.append(np.array(tris, np.float64).reshape(-1, 3, 3))
    return tables


_TRI_TABLE: list[np.ndarray] | None = None


def _tri_table() -> list[np.ndarray]:
    global _TRI_TABLE
    if _TRI_TABLE is None:
        _TRI_TABLE = _build_tables()
    return _TRI_TABLE


# ---------------------------------------------------------------------------
# mesh extraction + features
# ---------------------------------------------------------------------------


def _mesh_area_volume_verts(mask: np.ndarray, spacing) -> tuple[float, float,
                                                                np.ndarray]:
    """(surface_area_mm2, mesh_volume_mm3, vertex_points_mm) of the 0.5
    iso-surface. Vertices are deduplicated midpoints (half-integer grid)."""
    sp = np.asarray(spacing, np.float64)
    m = np.pad(np.asarray(mask, bool), 1).astype(np.int8)
    X, Y, Z = m.shape
    # cell corner values -> 8-bit config per cell
    cfg = np.zeros((X - 1, Y - 1, Z - 1), np.uint8)
    for i in range(8):
        dx, dy, dz = int(_CORNERS[i, 0]), int(_CORNERS[i, 1]), int(_CORNERS[i, 2])
        cfg |= (m[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1]
                << np.uint8(i)).astype(np.uint8)
    act = (cfg != 0) & (cfg != 255)
    cells = np.argwhere(act)
    if cells.size == 0:
        return 0.0, 0.0, np.zeros((0, 3))
    ccfg = cfg[act]
    table = _tri_table()
    area = 0.0
    vol6 = 0.0
    verts2: list[np.ndarray] = []  # 2x coordinates (integers) for dedup
    for c in np.unique(ccfg):
        tri = table[int(c)]
        if tri.shape[0] == 0:
            continue
        orig = cells[ccfg == c].astype(np.float64) - 1.0  # unpad
        # (ncell, ntri, 3, 3) physical coords
        pts = (orig[:, None, None, :] + tri[None]) * sp
        v0, v1, v2 = pts[..., 0, :], pts[..., 1, :], pts[..., 2, :]
        cr = np.cross(v1 - v0, v2 - v0)
        area += 0.5 * np.sqrt((cr * cr).sum(-1)).sum()
        vol6 += np.einsum("...i,...i->...", v0, np.cross(v1, v2)).sum()
        verts2.append(np.rint((orig[:, None, None, :] + tri[None]) * 2.0
                              ).astype(np.int64).reshape(-1, 3))
    allv = np.concatenate(verts2) if verts2 else np.zeros((0, 3), np.int64)
    uniq = np.unique(allv, axis=0).astype(np.float64) / 2.0 * sp
    return float(area), float(abs(vol6) / 6.0), uniq


def _hull2d(pts: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull of 2D points (compute/geometry.py
    `convex_hull` uses the same construction for the L3 body axes)."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    # a hull vertex is the lowest or the highest point of its x column
    # (np.unique sorts by x, then y): the chain on those alone gives the
    # same vertices in the same order
    new_x = pts[1:, 0] != pts[:-1, 0]
    pts = pts[np.r_[True, new_x] | np.r_[new_x, True]]
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    p = pts[order]

    def half(seq):
        out: list[np.ndarray] = []
        for q in seq:
            while len(out) >= 2:
                u, w = out[-1] - out[-2], q - out[-2]
                if u[0] * w[1] - u[1] * w[0] > 0:
                    break
                out.pop()
            out.append(q)
        return out[:-1]

    return np.array(half(p) + half(p[::-1]))


def _max_pairwise(pts: np.ndarray) -> float:
    if len(pts) < 2:
        return 0.0
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.max()))


def _max_diameter_3d(verts: np.ndarray) -> float:
    if len(verts) < 2:
        return 0.0
    pts = verts
    if len(pts) > 300:
        try:
            from scipy.spatial import ConvexHull

            pts = pts[ConvexHull(pts).vertices]
        except Exception:  # degenerate (planar) point sets
            pass
    if len(pts) > 4000:  # chunk the pairwise pass to bound memory
        best = 0.0
        for i in range(0, len(pts), 2000):
            d2 = ((pts[i:i + 2000, None, :] - pts[None, :, :]) ** 2).sum(-1)
            best = max(best, float(d2.max()))
        return float(np.sqrt(best))
    return _max_pairwise(pts)


def _max_diameter_2d(verts: np.ndarray, drop_axis: int) -> float:
    if len(verts) < 2:
        return 0.0
    keep = [a for a in range(3) if a != drop_axis]
    return _max_pairwise(_hull2d(verts[:, keep]))


def shape_features(mask: np.ndarray, spacing) -> dict:
    """The pyradiomics `shape` class for one binary mask.

    Keys match the reference's `standard_features` shape list
    (`totalsegmentator/statistics.py:22`). Axes follow the (x, y, z) voxel
    order of the array: `Maximum2DDiameterSlice` is in the x-y plane,
    `...Column` in x-z, `...Row` in y-z (pyradiomics' slice/column/row
    planes for an axial volume).
    """
    mask = np.asarray(mask).astype(bool)
    n = int(mask.sum())
    sp = np.asarray(spacing, np.float64)
    zero = {k: 0.0 for k in (
        "shape_Elongation", "shape_Flatness", "shape_LeastAxisLength",
        "shape_MajorAxisLength", "shape_Maximum2DDiameterColumn",
        "shape_Maximum2DDiameterRow", "shape_Maximum2DDiameterSlice",
        "shape_Maximum3DDiameter", "shape_MeshVolume",
        "shape_MinorAxisLength", "shape_Sphericity", "shape_SurfaceArea",
        "shape_SurfaceVolumeRatio", "shape_VoxelVolume")}
    if n == 0:
        return zero
    # bbox-scope the mesh pass (scipy find_objects rule does not apply: one
    # label, one np.argwhere-equivalent reduction)
    idx = np.nonzero(mask)
    lo = [int(i.min()) for i in idx]
    hi = [int(i.max()) + 1 for i in idx]
    sub = mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]

    area, vol, verts = _mesh_area_volume_verts(sub, sp)

    # physical-coordinate PCA of voxel centers (pyradiomics axis lengths)
    coords = np.stack(idx, axis=1).astype(np.float64) * sp
    if n > 1:
        cov = np.cov(coords, rowvar=False, bias=True)
        eig = np.clip(np.sort(np.linalg.eigvalsh(cov))[::-1], 0.0, None)
    else:
        eig = np.zeros(3)
    l1, l2, l3 = eig
    out = dict(zero)
    out["shape_VoxelVolume"] = float(n * np.prod(sp))
    out["shape_MeshVolume"] = vol
    out["shape_SurfaceArea"] = area
    if vol > 0:
        out["shape_SurfaceVolumeRatio"] = area / vol
        out["shape_Sphericity"] = float(
            (36.0 * np.pi * vol * vol) ** (1.0 / 3.0) / area)
    out["shape_MajorAxisLength"] = float(4.0 * np.sqrt(l1))
    out["shape_MinorAxisLength"] = float(4.0 * np.sqrt(l2))
    out["shape_LeastAxisLength"] = float(4.0 * np.sqrt(l3))
    if l1 > 0:
        out["shape_Elongation"] = float(np.sqrt(l2 / l1))
        out["shape_Flatness"] = float(np.sqrt(l3 / l1))
    out["shape_Maximum3DDiameter"] = _max_diameter_3d(verts)
    out["shape_Maximum2DDiameterSlice"] = _max_diameter_2d(verts, 2)
    out["shape_Maximum2DDiameterColumn"] = _max_diameter_2d(verts, 1)
    out["shape_Maximum2DDiameterRow"] = _max_diameter_2d(verts, 0)
    return out
