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


# Freeman directions of the border follower as (dx, dy) on the image (rows
# y down): 0 is +x, and the index runs counter-clockwise as displayed
_CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _follow_border(img: list, i0: int, hole: bool, deltas: list, width: int,
                   mark: int) -> list[tuple[int, int]]:
    """Suzuki-Abe border following from `i0` over the flat, zero-framed
    image `img` (0 background, 1 unvisited foreground, +-(id + 2) marks),
    as OpenCV's `icvFetchContour` does it: the first neighbour found
    clockwise from the background side, then counter-clockwise searches,
    the pixel marked -mark where its right neighbour was examined as
    background, else +mark when unvisited. Returns the simple-chain points
    (a point wherever the direction changes), in framed (x, y)."""
    s = s_end = 0 if hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    x, y = i0 % width, i0 // width
    if s == s_end:   # an isolated pixel
        img[i0] = -mark
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:   # the right neighbour was examined: background
            img[i3] = -mark
        elif img[i3] == 1:
            img[i3] = mark
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        dx, dy = _CODE_DELTAS[s]
        x += dx
        y += dy
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return pts


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """Outer and hole borders of the nonzero pixels of a 2D (rows, cols)
    mask, as OpenCV's `cv2.findContours(mask, cv2.RETR_CCOMP,
    cv2.CHAIN_APPROX_SIMPLE)[0]` returns them: each an (n, 1, 2) int32
    array of (x = col, y = row) points of border pixels, 8-connected
    foreground, only the points where the chain turns (a straight run keeps
    its ends); an isolated pixel gives one point. The order is OpenCV's
    two-level tree walked depth-first: outer borders last found first, each
    followed by its holes, last found first.

    The raster scan for border starts is numpy (every pixel with background
    on its left is an outer candidate, every background pixel with
    foreground on its left a hole candidate); the scan then visits only the
    candidates, in raster order, and the borders are followed in Python on
    the mask's bounding box with a zero frame (so a mask touching the edge
    is traced as OpenCV traces it after its one-pixel border)."""
    m = np.asarray(mask) != 0
    if m.ndim != 2:
        raise ValueError(f"find_contours takes a 2D mask, not {m.shape}")
    rows = np.flatnonzero(m.any(axis=1))
    if rows.size == 0:
        return []
    cols = np.flatnonzero(m.any(axis=0))
    y0, x0 = int(rows[0]), int(cols[0])
    sub = m[y0:int(rows[-1]) + 1, x0:int(cols[-1]) + 1]
    framed = np.zeros((sub.shape[0] + 2, sub.shape[1] + 2), np.int8)
    framed[1:-1, 1:-1] = sub
    width = framed.shape[1]
    left, here = framed[:, :-2], framed[:, 1:-1]   # the scan's x runs over 1 .. width - 2
    outer = (here == 1) & (left == 0)
    hole = (here == 0) & (left == 1)
    cand = np.flatnonzero((outer | hole).ravel())
    is_hole = hole.ravel()[cand]
    # flat index in the framed image: (y, x - 1) of the trimmed grid -> y * width + x
    starts = cand + cand // (width - 2) * 2 + 1
    img = framed.ravel().tolist()
    deltas = [1, 1 - width, -width, -width - 1, -1, width - 1, width, width + 1] * 2

    contours: list[list[tuple[int, int]]] = []
    holes: list[bool] = []
    parent: list[int] = []
    children: dict[int, list[int]] = {-1: []}   # -1: the frame
    for pos, h in zip(starts.tolist(), is_hole.tolist()):
        if h:
            if img[pos - 1] < 1:   # a right-bound border pixel: no new hole
                continue
            start = pos - 1
            # the nearest marked pixel to the left names the border around
            q = start
            while img[q] in (0, 1) and q % width:
                q -= 1
            if q % width == 0:
                par = -1
            else:
                owner = abs(img[q]) - 2
                par = parent[owner] if holes[owner] else owner
        else:
            if img[pos] != 1:   # visited by an earlier border
                continue
            start, par = pos, -1
        cid = len(contours)
        contours.append(_follow_border(img, start, h, deltas, width, cid + 2))
        holes.append(h)
        parent.append(par)
        children[cid] = []
        children[par].append(cid)

    order: list[int] = []

    def walk(node: int) -> None:   # each list newest first, as OpenCV links them
        for k in reversed(children[node]):
            order.append(k)
            walk(k)

    walk(-1)
    off = np.array([x0 - 1, y0 - 1], np.int32)
    return [(np.asarray(contours[k], np.int32) + off).reshape(-1, 1, 2) for k in order]
