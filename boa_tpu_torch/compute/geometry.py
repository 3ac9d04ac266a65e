"""Body-axis geometry on an axial slice.

Counterpart of `boa_tpu/compute/geometry.py` (body_organ_analysis
`compute/geometry.py:49-85`): the major axis of a binary body mask is the
farthest-apart pair of outline points; the minor axis is the perpendicular
through the major axis' midpoint, cut off at the body outline on both
sides. The convex hull is Andrew's monotone chain, the widest pair a
distance matrix over the hull, and the minor endpoints the scan-order-first
outline pixels on the perpendicular ray (scipy for the outline band).
"""

from __future__ import annotations

import numpy as np

Point = np.ndarray  # shape (2,), (x, y) pixel coordinates


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull of an (N, 2) point set, CCW order.

    Returns the hull vertices; degenerate inputs (<3 distinct points or
    all collinear) return the distinct points themselves.
    """
    pts = np.unique(points, axis=0)  # sorts lexicographically (x, then y)
    if len(pts) <= 2:
        return pts

    def half_hull(seq):
        chain: list[np.ndarray] = []
        for p in seq:
            while len(chain) >= 2:
                a, b = chain[-2], chain[-1]
                if (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) <= 0:
                    chain.pop()
                else:
                    break
            chain.append(p)
        return chain

    lower = half_hull(pts)
    upper = half_hull(pts[::-1])
    hull = lower[:-1] + upper[:-1]
    if len(hull) < 3:  # collinear input
        return pts
    return np.asarray(hull)


def widest_pair(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The two points of an (N, 2) set with maximal euclidean separation."""
    diff = points[:, None, :].astype(np.float64) - points[None, :, :]
    d2 = np.einsum("ijk,ijk->ij", diff, diff)
    i, j = np.unravel_index(int(d2.argmax()), d2.shape)
    return points[i], points[j]


def _minor_point_on_ray(boundary: np.ndarray, origin: np.ndarray,
                        direction: np.ndarray) -> np.ndarray | None:
    """Scan-order-first OUTLINE pixel on origin + t*direction (t >= 0).

    The reference rasterizes the contour (thickness 2) and the ray, then
    takes `nonzero()[...][0]` of their intersection — the smallest-(y, x)
    pixel in row-major order, NOT the crossing nearest/farthest along the
    ray (geometry.py:20-46). Results diverge whenever the perpendicular
    crosses the outline more than once (concavities, arms), so the
    selection rule must match.
    """
    h, w = boundary.shape  # indexed [row=y, col=x]
    reach = float(h + w)
    ts = np.arange(0.0, reach, 0.5)
    xs = np.rint(origin[0] + ts * direction[0]).astype(np.int64)
    ys = np.rint(origin[1] + ts * direction[1]).astype(np.int64)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys = xs[inside], ys[inside]
    hit = boundary[ys, xs]
    if not hit.any():
        return None
    xs, ys = xs[hit], ys[hit]
    k = int(np.argmin(ys * w + xs))
    return np.array([xs[k], ys[k]], np.float64)


def find_axes(middle_slice: np.ndarray):
    """(major_p1, major_p2, minor_p1, minor_p2) of a binary mask slice,
    each an (x, y) array, or Nones when the slice is degenerate."""
    mask = np.asarray(middle_slice) != 0
    rows, cols = np.nonzero(mask)
    if len(rows) == 0:
        return None, None, None, None
    # hull candidates: only row-extremal pixels (min/max x per y) can be
    # hull vertices — cuts the python monotone chain from ~200k points on
    # a body slice to <=2*rows
    order = np.lexsort((cols, rows))
    r_sorted, c_sorted = rows[order], cols[order]
    first = np.searchsorted(r_sorted, np.unique(r_sorted), side="left")
    last = np.searchsorted(r_sorted, np.unique(r_sorted), side="right") - 1
    cand = np.concatenate([order[first], order[last]])
    pts = np.stack([cols[cand], rows[cand]], axis=1)  # (x, y)
    hull = convex_hull(pts)
    if len(hull) < 2:
        return None, None, None, None
    major_a, major_b = widest_pair(hull)
    major_a = major_a.astype(np.float64)
    major_b = major_b.astype(np.float64)

    mid = np.floor((major_a + major_b) / 2.0)
    axis_vec = major_a - major_b
    norm = float(np.hypot(*axis_vec))
    if norm == 0.0:
        return None, None, None, None
    # unit perpendicular (x, y) -> (-y, x)
    perp = np.array([-axis_vec[1], axis_vec[0]]) / norm
    from scipy import ndimage

    # ~thickness-2 outline band, matching the reference's drawContours
    # raster (thin 1-px outlines can slip between half-pixel ray samples)
    outline = mask & ~ndimage.binary_erosion(mask)
    boundary = ndimage.binary_dilation(outline)
    minor_a = _minor_point_on_ray(boundary, mid, perp)
    minor_b = _minor_point_on_ray(boundary, mid, -perp)
    return major_a, major_b, minor_a, minor_b
