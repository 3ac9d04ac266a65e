"""A float RGB canvas for the PNG renderers, in numpy.

Pixel coordinates: x to the right, y down, (0, 0) the top-left corner of
the top-left pixel; a box is (x, y, width, height). Images are float arrays
in [0, 1], (rows, cols, 3) or with alpha (rows, cols, 4), drawn
nearest-neighbour as matplotlib's `imshow(..., interpolation="nearest")`
lays them out.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from boa_tpu_torch.render import font, png
from boa_tpu_torch.render.colors import to_rgb

_GRAY_N = 256   # matplotlib's "gray" table


def gray(values: np.ndarray) -> np.ndarray:
    """`imshow(values, cmap="gray")`'s colours: min-max scaled to [0, 1]
    (all 0 when the values are constant), then the 256-entry gray table
    by matplotlib's index rule."""
    v = np.asarray(values, np.float64)
    lo, hi = float(v.min()), float(v.max())
    x = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.clip((x * _GRAY_N).astype(np.int64), 0, _GRAY_N - 1)
    g = (idx / (_GRAY_N - 1)).astype(np.float32)
    return np.repeat(g[..., None], 3, axis=-1)


def image_rect(box, rows: int, cols: int, aspect: float | None = None) -> tuple:
    """Where `imshow` puts a rows x cols image in `box`: the whole box for
    `aspect=None` ("auto"), else the largest centred rectangle whose height
    over width is `aspect * rows / cols`."""
    x, y, w, h = box
    if aspect is None:
        return x, y, w, h
    ratio = aspect * rows / cols
    if h / w > ratio:
        iw, ih = w, w * ratio
    else:
        iw, ih = h / ratio, h
    return x + (w - iw) / 2, y + (h - ih) / 2, iw, ih


class Canvas:
    """`rgb` is the (height, width, 3) float32 image drawn so far."""

    def __init__(self, width: int, height: int, color="#000000") -> None:
        self.rgb = np.empty((height, width, 3), np.float32)
        self.rgb[:] = to_rgb(color)

    @property
    def width(self) -> int:
        return self.rgb.shape[1]

    @property
    def height(self) -> int:
        return self.rgb.shape[0]

    def fill(self, color, box=None) -> None:
        """Paint `box` (default: the canvas) with `color`; the box snaps to
        the pixels whose centres it holds."""
        x, y, w, h = box if box is not None else (0, 0, self.width, self.height)
        cols, rows = self._span(x, w, self.width), self._span(y, h, self.height)
        self.rgb[rows, cols] = to_rgb(color)

    @staticmethod
    def _span(start: float, size: float, limit: int) -> slice:
        """The pixels whose centres lie in [start, start + size)."""
        lo = max(0, math.ceil(start - 0.5))
        hi = min(limit, math.ceil(start + size - 0.5))
        return slice(lo, max(lo, hi))

    def blit(self, img: np.ndarray, rect, origin: str = "upper") -> None:
        """Draw `img` nearest-neighbour into `rect` (see `image_rect`): each
        pixel takes the image sample under its centre. `origin="lower"`
        puts row 0 at the bottom. An alpha channel composites over what is
        drawn: out = rgb * a + below * (1 - a)."""
        img = np.asarray(img, np.float32)
        rows, cols = img.shape[:2]
        x, y, w, h = rect
        px = np.arange(self.width)[self._span(x, w, self.width)]
        py = np.arange(self.height)[self._span(y, h, self.height)]
        if not len(px) or not len(py):
            return
        sc = np.clip(((px + 0.5 - x) / w * cols).astype(np.int64), 0, cols - 1)
        sr = np.clip(((py + 0.5 - y) / h * rows).astype(np.int64), 0, rows - 1)
        if origin == "lower":
            sr = rows - 1 - sr
        elif origin != "upper":
            raise ValueError(f"origin must be 'upper' or 'lower', got {origin!r}")
        src = img[sr[:, None], sc[None, :]]
        dst = self.rgb[py[0]:py[-1] + 1, px[0]:px[-1] + 1]
        if src.shape[-1] == 4:
            a = src[..., 3:4]
            dst[:] = src[..., :3] * a + dst * (1.0 - a)
        else:
            dst[:] = src

    def line(self, p0, p1, color, width: float) -> None:
        """A segment `width` pixels wide: every pixel whose centre lies
        within width / 2 of the segment p0-p1 (round ends)."""
        (x0, y0), (x1, y1) = p0, p1
        r = width / 2
        # the candidates: a pixel more on each side than the segment's
        # bounds; the distance decides
        cols = self._span(min(x0, x1) - r - 1, abs(x1 - x0) + 2 * r + 2, self.width)
        rows = self._span(min(y0, y1) - r - 1, abs(y1 - y0) + 2 * r + 2, self.height)
        cx = np.arange(self.width)[cols][None, :] + 0.5
        cy = np.arange(self.height)[rows][:, None] + 0.5
        dx, dy = x1 - x0, y1 - y0
        n2 = dx * dx + dy * dy
        t = np.clip(((cx - x0) * dx + (cy - y0) * dy) / n2, 0, 1) if n2 else 0.0
        dist2 = (cx - x0 - t * dx) ** 2 + (cy - y0 - t * dy) ** 2
        self.rgb[rows, cols][dist2 <= r * r] = to_rgb(color)

    def text(self, s: str, x: float, y: float, color, scale: int = 1,
             anchor: str = "center") -> None:
        """A line of bitmap text (`font.py`) whose cells' top edge is at `y`;
        `x` is its centre (`anchor="center"`) or its left edge ("left")."""
        mask = font.text_mask(s, scale)
        left = x - mask.shape[1] / 2 if anchor == "center" else x
        x0, y0 = int(round(left)), int(round(y))
        ys, xs = np.nonzero(mask)
        ys, xs = ys + y0, xs + x0
        keep = (xs >= 0) & (xs < self.width) & (ys >= 0) & (ys < self.height)
        self.rgb[ys[keep], xs[keep]] = to_rgb(color)

    def to_uint8(self) -> np.ndarray:
        return np.round(np.clip(self.rgb, 0.0, 1.0) * 255).astype(np.uint8)

    def save_png(self, path: str | Path) -> None:
        png.write(path, self.to_uint8())
