"""BCA report rendering: the tissue colours, the heatmap and overlay arrays,
and the PDF report on the port's own writer (`render/pdf.py`).

Counterpart of `boa_tpu/bca/plots.py`, which draws the same pages with
matplotlib's `PdfPages`: (1) the eight tissue curves over the slices with
the secondary findings, (2) the coronal and sagittal tissue heatmaps, (3)
the slice-check strip of 12 CT slices with the tissue overlay, then (4+)
one page per aggregation window with its two tables (with and without the
extremities) and its mid-slice overlay. The layout follows matplotlib's
defaults (subplot margins and spacing, font sizes, table cell colours);
the pages carry the same text and the same image arrays, and are not drawn
to the pixel. Fixed tissue colours follow `report/plots/colors.py:8-29`.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from boa_tpu_torch.bca.definitions import Tissue
from boa_tpu_torch.render import pdf
from boa_tpu_torch.render.colors import to_rgb

# fixed color map per tissue (report/plots/colors.py)
TISSUE_COLORS = {
    "Muscle": "#e41a1c",
    "Bone": "#f5f5f5",
    "SAT": "#ffff33",
    "VAT": "#ff7f00",
    "IMAT": "#984ea3",
    "PAT": "#4daf4a",
    "EAT": "#377eb8",
    "TAT": "#a65628",
}
CURVES = ["Muscle", "TAT", "SAT", "VAT", "IMAT", "PAT", "EAT", "Bone"]


def _name(t: Tissue) -> str:
    return t.name.capitalize() if t in (Tissue.BONE, Tissue.MUSCLE) else t.name


def tissue_densities(tissues: np.ndarray, axis: int) -> np.ndarray:
    """(n_tissues, h, w) float32 density fractions of each Tissue along
    `axis`."""
    depth = tissues.shape[axis]
    return np.stack([(tissues == int(t)).sum(axis=axis, dtype=np.float32) / depth
                     for t in Tissue])


def heatmap_rgb(density: np.ndarray) -> np.ndarray:
    """Colorize a (n_tissues, h, w) density stack with the fixed tissue
    colors."""
    rgb = np.zeros((*density.shape[1:], 3))
    for i, t in enumerate(Tissue):
        rgb += density[i][..., None] * np.array(to_rgb(TISSUE_COLORS[_name(t)]))[None, None]
    return np.clip(rgb, 0, 1)


def tissue_heatmap(tissues: np.ndarray, axis: int) -> np.ndarray:
    """Density projection of each tissue along `axis` (coronal: y, sagittal:
    x)."""
    return heatmap_rgb(tissue_densities(tissues, axis))


def axial_overlay(ct_slices: np.ndarray, tis_slices: np.ndarray) -> np.ndarray:
    """Soft-tissue-windowed CT with alpha-blended tissue colors,
    (x, y, n) -> (x, y, n, 3)."""
    g = np.clip((ct_slices.astype(np.float32) + 150.0) / 400.0, 0.0, 1.0)
    rgb = np.repeat(g[..., None], 3, axis=-1)
    for t in Tissue:
        color = np.asarray(to_rgb(TISSUE_COLORS[_name(t)]), np.float32)
        m = tis_slices == int(t)
        rgb[m] = 0.45 * rgb[m] + 0.55 * color
    return rgb


# --- page layout: matplotlib's figure defaults, in points -------------------
PAGE_W, PAGE_H = pdf.A4
_LEFT, _RIGHT = 0.125 * PAGE_W, 0.9 * PAGE_W
_BOTTOM, _TOP = 0.11 * PAGE_H, 0.88 * PAGE_H
_TICK = 3.5            # tick length and the gap to its label
_WHITE, _BLACK = "#ffffff", "#000000"


def _grid(nrows: int, ncols: int, height_ratios=None, space: float = 0.2) -> list[tuple]:
    """`plt.subplots(nrows, ncols)`'s axes boxes (x, y, w, h), row-major from
    the top, with `hspace = wspace = space`."""
    cell_w = (_RIGHT - _LEFT) / (ncols + space * (ncols - 1))
    cell_h = (_TOP - _BOTTOM) / (nrows + space * (nrows - 1))
    ratios = np.asarray(height_ratios or [1] * nrows, np.float64)
    heights = cell_h * nrows * ratios / ratios.sum()
    boxes = []
    top = _TOP
    for r in range(nrows):
        for c in range(ncols):
            boxes.append((_LEFT + c * cell_w * (1 + space), top - heights[r],
                          cell_w, heights[r]))
        top -= heights[r] + space * cell_h
    return boxes


def _title(page: pdf.Page, box, s: str, color, size: float = 12.0) -> None:
    x, y, w, h = box
    page.text(x + w / 2, y + h + 6, s, size, color, align="center")


def _ticks(lo: float, hi: float, n: int = 6) -> np.ndarray:
    """Round tick positions (1, 2, 2.5 or 5 times a power of ten) in [lo, hi]."""
    span = hi - lo if hi > lo else 1.0
    raw = span / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step) * step
    return np.arange(first, hi + step * 1e-9, step)


def _tick_label(v: float, step: float) -> str:
    """`v` with as many decimals as the tick step has."""
    decimals = 0
    while decimals < 6 and abs(step * 10 ** decimals - round(step * 10 ** decimals)) > 1e-6:
        decimals += 1
    s = f"{v:.{decimals}f}"
    return s[1:] if float(s) == 0 and s.startswith("-") else s


def _axis_range(values: np.ndarray) -> tuple[float, float]:
    """matplotlib's data limits with its 5 % margins."""
    lo, hi = float(np.min(values)), float(np.max(values))
    if hi == lo:
        lo, hi = lo - 0.5, hi + 0.5
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


def _curves(page: pdf.Page, box, table: dict[str, np.ndarray], title: str,
            face: str, txt: str) -> None:
    x0, y0, w, h = box
    page.rect(x0, y0, w, h, fill=face)
    xs = np.asarray(table["slice_idx"], np.float64)
    ys = {c: np.asarray(table[c], np.float64) for c in CURVES}
    label_w = 0.0   # the widest y tick label
    if len(xs):
        xlo, xhi = _axis_range(xs)
        ylo, yhi = _axis_range(np.concatenate(list(ys.values())))
        for col in CURVES:
            page.polyline(zip(x0 + (xs - xlo) / (xhi - xlo) * w,
                              y0 + (ys[col] - ylo) / (yhi - ylo) * h),
                          TISSUE_COLORS[col], 1.2)
        for axis, (lo, hi) in (("x", (xlo, xhi)), ("y", (ylo, yhi))):
            ticks = _ticks(lo, hi)
            step = float(ticks[1] - ticks[0]) if len(ticks) > 1 else 1.0
            for t in ticks:
                label = _tick_label(float(t), step)
                if axis == "x":
                    px = x0 + (t - lo) / (hi - lo) * w
                    page.polyline([(px, y0), (px, y0 - _TICK)], txt, 0.8)
                    page.text(px, y0 - 2 * _TICK - 10, label, 10, txt, align="center")
                else:
                    py = y0 + (t - lo) / (hi - lo) * h
                    page.polyline([(x0, py), (x0 - _TICK, py)], txt, 0.8)
                    page.text(x0 - 2 * _TICK, py - 3.5, label, 10, txt, align="right")
                    label_w = max(label_w, pdf.text_width(label, 10))
    page.text(x0 - 2 * _TICK - label_w - 6, y0 + h / 2, "volume per slice [ml]", 10, txt,
              align="center", rotate=True)
    page.rect(x0, y0, w, h, stroke=_BLACK, line_width=0.8)
    page.text(x0 + w / 2, y0 - 2 * _TICK - 10 - 16, "slice index", 10, txt, align="center")
    _title(page, box, title, txt)
    # the legend, upper right, fontsize 7 (matplotlib's own colours)
    size, row = 7.0, 7.0 * 1.7
    handle, gap, pad = 2.0 * size, 0.8 * size, 0.4 * size
    lw = pad * 2 + handle + gap + max(pdf.text_width(c, size) for c in CURVES)
    lh = pad * 2 + row * len(CURVES)
    lx, ly = x0 + w - 0.5 * 10 - lw, y0 + h - 0.5 * 10 - lh
    page.rect(lx, ly, lw, lh, fill=_WHITE, stroke="#cccccc", line_width=0.8)
    for i, col in enumerate(CURVES):
        base = ly + lh - pad - row * (i + 1) + 0.3 * row
        page.polyline([(lx + pad, base + 2.5), (lx + pad + handle, base + 2.5)],
                      TISSUE_COLORS[col], 1.2)
        page.text(lx + pad + handle + gap, base, col, size, _BLACK)


def _cell(v) -> str:
    return f"{v:.2f}" if isinstance(v, (int, float)) else "-"


def _table(page: pdf.Page, box, stats: dict[str, dict], title: str, txt: str) -> None:
    """`ax.table(cellText, rowLabels, colLabels, loc="upper center")` at
    fontsize 7: white cells, black edges and text; the row labels to the
    left of the axes."""
    x0, y0, w, h = box
    _title(page, box, title, txt)
    cols = list(stats)
    rows = list(stats[cols[0]]) if cols else []
    size, row_h, pad = 7.0, 12.0, 2.0
    col_w = w / max(len(cols), 1)
    label_w = max([pdf.text_width(r, size) for r in rows] or [0.0]) + 2 * pad
    top = y0 + h
    cells = [(x0 + j * col_w, top - row_h, col_w, c, "center") for j, c in enumerate(cols)]
    for i, r in enumerate(rows):
        y = top - row_h * (i + 2)
        cells.append((x0 - label_w, y, label_w, r, "left"))
        cells += [(x0 + j * col_w, y, col_w, _cell(stats[c][r]), "right")
                  for j, c in enumerate(cols)]
    for x, y, cw, s, align in cells:
        page.rect(x, y, cw, row_h, fill=_WHITE, stroke=_BLACK, line_width=0.5)
        tx = {"left": x + pad, "center": x + cw / 2, "right": x + cw - pad}[align]
        page.text(tx, y + (row_h - size) / 2 + 1, s, size, _BLACK, align=align)


def render_report_pdf(builder, prepared: dict[str, Any], version: str) -> bytes:
    """The report's pages from `Builder.prepare`'s output alone (no device
    access: this may run on the HostWorker); `builder` gives the theme."""
    dark = builder.theme == "dark"
    face = "#1c1c1c" if dark else _WHITE
    txt = _WHITE if dark else _BLACK
    doc = pdf.Document()

    def new_page() -> pdf.Page:
        page = doc.add_page()
        page.rect(0, 0, PAGE_W, PAGE_H, fill=face)
        return page

    # page 1: summary curves + findings
    page = new_page()
    top, bottom = _grid(2, 1, height_ratios=[2, 1])
    _curves(page, top, prepared["slicewise_measurements"],
            f"Body Composition Analysis (boa-tpu {version})", face, txt)
    findings = prepared.get("other_findings") or ["No secondary findings."]
    x, y, w, h = bottom
    lines = ["Secondary findings:"] + [f"  • {f}" for f in findings]
    for i, line in enumerate(lines):
        page.text(x + 0.02 * w, y + 0.95 * h - 9 - i * 9 * 1.2, line, 9, txt)

    # page 2: heatmaps
    page = new_page()
    densities = prepared["tissue_density"]
    for box, (axis, name) in zip(_grid(1, 2), [(1, "coronal"), (0, "sagittal")]):
        page.image(np.rot90(heatmap_rgb(densities[axis])), *box)
        _title(page, box, f"{name} tissue heatmap", txt)

    # page 3: equidistant slice-check strip
    sc = prepared["equidistant_slice_check"]
    chk, mids = sc["check_idxs"], sc["mid_idxs"]
    n_chk = len(chk)
    overlays = axial_overlay(sc["ct_slices"], sc["tissue_slices"])
    page = new_page()
    for k, box in enumerate(_grid(3, 4)):
        if k < n_chk:
            page.image(np.rot90(overlays[:, :, k]), *box)
            _title(page, box, f"slice {int(chk[k])}", txt, size=8)
    page.text(PAGE_W / 2, 0.98 * PAGE_H - 12, "Slice check — tissue overlay", 12, txt,
              align="center")

    # page 4+: aggregated tables with and without extremities, and the
    # window's mid-slice overlay
    for j, (name, (lo, hi), _, stats, stats_nl) in enumerate(prepared["aggregated_measurements"]):
        page = new_page()
        boxes = _grid(3, 1, height_ratios=[4, 4, 3])
        _table(page, boxes[0], stats, f"{name} (slices {lo}-{hi})", txt)
        _table(page, boxes[1], stats_nl, f"{name} — NoExtremities", txt)
        page.image(np.rot90(overlays[:, :, n_chk + j]), *boxes[2])
        _title(page, boxes[2], f"mid slice {mids[j]}", txt, size=8)
    return doc.tobytes()
