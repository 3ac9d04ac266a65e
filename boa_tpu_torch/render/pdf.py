"""A PDF 1.4 writer: pages of any size with filled rectangles, polylines,
text in the standard Helvetica font and RGB images.

Text uses the base-14 Helvetica with /WinAnsiEncoding (no font is
embedded), so "•" and "—" draw as themselves. Page content and images are
FlateDecode streams. The file has no /Info dictionary and no creation date,
so the same drawing calls always give the same bytes. Coordinates are PDF
points (1/72 in), from the bottom-left corner of the page.
"""

from __future__ import annotations

import zlib

import numpy as np

from boa_tpu_torch.render.colors import to_rgb

#: matplotlib's MediaBox for a figure of 8.3 x 11.7 in
A4 = (597.6, 842.4)

# Helvetica's advance widths (1/1000 em) of WinAnsi codes 32-126, from the
# font's Adobe metrics
_WIDTHS = dict(zip(range(32, 127), (
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333, 278, 278,
    556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278, 584, 584, 584, 556,
    1015, 667, 667, 722, 722, 667, 611, 778, 722, 278, 500, 667, 556, 833, 722, 778,
    667, 778, 722, 667, 611, 722, 667, 944, 667, 667, 611, 278, 278, 278, 469, 556,
    333, 556, 556, 500, 556, 556, 278, 556, 556, 222, 222, 500, 222, 833, 556, 556,
    556, 556, 333, 500, 278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584)))
_WIDTHS.update({0x95: 350, 0x96: 556, 0x97: 1000})   # bullet, en and em dash
_AVERAGE = 556   # a code outside the table


def _encode(s: str) -> bytes:
    return s.encode("cp1252", errors="replace")


def text_width(s: str, size: float) -> float:
    """The advance of `s` in Helvetica at `size` points."""
    return sum(_WIDTHS.get(b, _AVERAGE) for b in _encode(s)) * size / 1000.0


def _num(v: float) -> str:
    s = f"{v:.3f}".rstrip("0").rstrip(".")
    return "0" if s in ("", "-0") else s


def _rgb(color) -> str:
    return " ".join(_num(c) for c in to_rgb(color))


def _string(s: str) -> bytes:
    b = _encode(s).replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)")
    return b"(" + b.replace(b"\r", b"\\r").replace(b"\n", b"\\n") + b")"


class Page:
    """One page's drawing calls, in painting order."""

    def __init__(self, width: float, height: float) -> None:
        self.width, self.height = width, height
        self._ops: list[bytes] = []
        self.images: list[np.ndarray] = []   # uint8 (h, w, 3), named /Im1, /Im2, ...

    def rect(self, x: float, y: float, w: float, h: float, fill=None, stroke=None,
             line_width: float = 1.0) -> None:
        ops = ["q"]
        if fill is not None:
            ops.append(f"{_rgb(fill)} rg")
        if stroke is not None:
            ops.append(f"{_rgb(stroke)} RG {_num(line_width)} w")
        paint = "B" if fill is not None and stroke is not None else "f" if fill is not None else "S"
        ops.append(f"{_num(x)} {_num(y)} {_num(w)} {_num(h)} re {paint} Q")
        self._ops.append(" ".join(ops).encode())

    def polyline(self, points, color, line_width: float = 1.0) -> None:
        pts = [(float(x), float(y)) for x, y in points]
        if len(pts) < 2:
            return
        path = [f"{_num(pts[0][0])} {_num(pts[0][1])} m"]
        path += [f"{_num(x)} {_num(y)} l" for x, y in pts[1:]]
        self._ops.append(f"q {_rgb(color)} RG {_num(line_width)} w 1 J 1 j "
                         f"{' '.join(path)} S Q".encode())

    def text(self, x: float, y: float, s: str, size: float = 10.0, color="#000000",
             align: str = "left", rotate: bool = False) -> None:
        """`s` on one line with its baseline at `y`; `x` is its left edge,
        centre or right edge by `align`. `rotate` turns it 90 degrees
        counter-clockwise about (x, y), the alignment then along y."""
        shift = {"left": 0.0, "center": 0.5, "right": 1.0}[align] * text_width(s, size)
        if rotate:
            matrix = f"0 1 -1 0 {_num(x)} {_num(y - shift)}"
        else:
            matrix = f"1 0 0 1 {_num(x - shift)} {_num(y)}"
        self._ops.append(f"q {_rgb(color)} rg BT /F1 {_num(size)} Tf {matrix} Tm ".encode()
                         + _string(s) + b" Tj ET Q")

    def image(self, img: np.ndarray, x: float, y: float, w: float, h: float) -> None:
        """An RGB image stretched over the box with its lower-left corner at
        (x, y); row 0 on top. A float image in [0, 1] is stored as
        round(255 * value), a uint8 one as it is."""
        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = np.round(np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
        if a.ndim != 3 or a.shape[2] != 3 or 0 in a.shape:
            raise ValueError(f"need an (h, w, 3) image, got {a.shape}")
        self.images.append(np.ascontiguousarray(a))
        self._ops.append(f"q {_num(w)} 0 0 {_num(h)} {_num(x)} {_num(y)} cm "
                         f"/Im{len(self.images)} Do Q".encode())

    def content(self) -> bytes:
        return b"\n".join(self._ops)


class Document:
    """Pages in order; `tobytes` writes the file."""

    def __init__(self) -> None:
        self.pages: list[Page] = []

    def add_page(self, width: float = A4[0], height: float = A4[1]) -> Page:
        page = Page(width, height)
        self.pages.append(page)
        return page

    def tobytes(self) -> bytes:
        # objects: 1 catalog, 2 page tree, 3 font, then per page its page
        # object, its content stream and its images
        objs: dict[int, bytes] = {
            3: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
               b"/Encoding /WinAnsiEncoding >>"}
        kids = []
        num = 4
        for page in self.pages:
            page_num, content_num = num, num + 1
            image_nums = list(range(num + 2, num + 2 + len(page.images)))
            num += 2 + len(page.images)
            kids.append(page_num)
            xobjects = " ".join(f"/Im{i + 1} {n} 0 R" for i, n in enumerate(image_nums))
            objs[page_num] = (
                f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {_num(page.width)} "
                f"{_num(page.height)}] /Resources << /Font << /F1 3 0 R >> "
                f"/XObject << {xobjects} >> >> /Contents {content_num} 0 R >>").encode()
            objs[content_num] = _stream(b"", page.content())
            for n, img in zip(image_nums, page.images):
                h, w, _ = img.shape
                objs[n] = _stream(f"/Type /XObject /Subtype /Image /Width {w} /Height {h} "
                                  f"/ColorSpace /DeviceRGB /BitsPerComponent 8 ".encode(),
                                  img.tobytes())
        objs[1] = b"<< /Type /Catalog /Pages 2 0 R >>"
        objs[2] = (f"<< /Type /Pages /Kids [{' '.join(f'{k} 0 R' for k in kids)}] "
                   f"/Count {len(kids)} >>").encode()

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for n in range(1, num):
            offsets.append(len(out))
            out += f"{n} 0 obj\n".encode() + objs[n] + b"\nendobj\n"
        xref = len(out)
        out += f"xref\n0 {num}\n0000000000 65535 f \n".encode()
        out += b"".join(f"{off:010d} 00000 n \n".encode() for off in offsets)
        out += (f"trailer\n<< /Size {num} /Root 1 0 R >>\nstartxref\n{xref}\n"
                f"%%EOF\n").encode()
        return bytes(out)


def _stream(entries: bytes, data: bytes) -> bytes:
    body = zlib.compress(data)
    return (b"<< " + entries + f"/Filter /FlateDecode /Length {len(body)} >>\nstream\n".encode()
            + body + b"\nendstream")
