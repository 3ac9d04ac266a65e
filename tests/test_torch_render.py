"""The port's drawing layer (boa_tpu_torch/render) and the BCA PDF report
(boa_tpu_torch/bca/plots.py) against matplotlib and the reference
(boa_tpu/bca/plots.py), on the CPU.

Bars: the turbo table and `cmap` equal to matplotlib's at 1e-7, `to_rgb`
and the gray colormap equal; the tissue heatmap, densities and overlays
within 1e-6 of the reference's; PNG files decode (PIL) to the canvas drawn,
and are the same bytes for the same array; every PDF xref offset points at
its object. The report: the reference's page count and MediaBox, every
string the reference's figures carry on each page (tick labels excepted),
and each embedded image equal to round(255 x) of the reference's array.
"""

import re
import zlib
from collections import Counter

import matplotlib
import numpy as np
import pytest
from PIL import Image

from boa_tpu.bca import plots as jplots
from boa_tpu_torch.bca import plots as tplots
from boa_tpu_torch.render import colors, font, pdf, png, raster
from tests.test_bca import synthetic_study  # noqa: F401 (fixture)
from tests.test_torch_bca import VERTEBRAE, builders  # noqa: F401 (fixture)

matplotlib.use("Agg")


# --- colours ----------------------------------------------------------------

def test_turbo_matches_matplotlib():
    ref = matplotlib.colormaps["turbo"]
    np.testing.assert_allclose(colors.TURBO, ref(np.arange(256))[:, :3], rtol=0, atol=1e-7)
    for x in [0.0, 1e-9, 0.2, 1 / 3, 0.5, 2 / 3, 0.999, 1.0, 1.5, -0.2]:
        np.testing.assert_allclose(colors.cmap(colors.TURBO, x), ref(x)[:3], rtol=0,
                                   atol=1e-7, err_msg=str(x))
    for n in (2, 5, 21, 26):   # the preview's group sizes
        for i in range(n):
            assert colors.cmap(colors.TURBO, i / (n - 1)) == pytest.approx(
                ref(i / (n - 1))[:3], abs=1e-7)


def test_to_rgb_matches_matplotlib():
    for c in [*tplots.TISSUE_COLORS.values(), "#1c1c1c", "#000000", "#ffffff"]:
        assert colors.to_rgb(c) == matplotlib.colors.to_rgb(c)
    assert colors.to_rgb((0.0, 0.5, 0.0, 1.0)) == (0.0, 0.5, 0.0)
    with pytest.raises(ValueError):
        colors.to_rgb("green")


def test_gray_matches_matplotlib():
    """`imshow(v, cmap="gray")`'s colour of every value: the gray table
    indexed by matplotlib's rule after min-max scaling."""
    v = np.random.default_rng(0).normal(size=(7, 9)) * 300
    norm = matplotlib.colors.Normalize(v.min(), v.max())
    want = matplotlib.colormaps["gray"](norm(v))[..., :3]
    np.testing.assert_allclose(raster.gray(v), want, rtol=0, atol=1e-7)
    assert not raster.gray(np.full((3, 3), 5.0)).any()   # constant: the first entry


# --- PNG ----------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (37, 53, channels), np.uint8)
    png.write(tmp_path / "a.png", img)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == ("RGB" if channels == 3 else "RGBA")
        np.testing.assert_array_equal(np.asarray(im), img)
    assert png.encode(img) == png.encode(img.copy())   # deterministic
    with pytest.raises(ValueError):
        png.encode(img.astype(np.float32))


def test_canvas_draws_what_the_png_holds(tmp_path):
    """Fill, blit (upper and lower origin, alpha), lines and text: the PNG
    decodes to the canvas' uint8 image, and each call lands where it should."""
    c = raster.Canvas(120, 80, "#1c1c1c")
    c.fill("#ff0000", (10, 10, 20, 10))
    ramp = raster.gray(np.arange(12.0).reshape(3, 4))
    rect = raster.image_rect((40, 0, 80, 80), 3, 4, aspect=1.0)
    assert rect == pytest.approx((40, 10, 80, 60))
    c.blit(ramp, rect, origin="lower")
    rgba = np.zeros((2, 2, 4), np.float32)
    rgba[..., 1] = rgba[..., 3] = 1.0
    rgba[0, 0, 3] = 0.5
    c.blit(rgba, (0, 60, 20, 20))
    c.line((0, 40), (30, 40), (0.0, 0.0, 1.0), 3)
    c.text("Ag", 20, 0, "#ffffff", scale=1)
    c.save_png(tmp_path / "c.png")
    with Image.open(tmp_path / "c.png") as im:
        np.testing.assert_array_equal(np.asarray(im), c.to_uint8())
    px = c.to_uint8()
    assert (px[10:20, 10:30] == [255, 0, 0]).all() and (px[9, 10] == 28).all()
    # origin="lower": the ramp's row 0 (its darkest values) at the bottom
    assert px[69, 45, 0] == 0 and px[10, 115, 0] == 255
    assert px[65, 5, 1] == round(255 * (0.5 + 0.5 * 28 / 255))   # alpha 0.5 over the face
    assert (px[70, 15] == [0, 255, 0]).all()
    # width 3: the rows whose centres lie within 1.5 of y = 40
    assert (px[38:42, 5] == [0, 0, 255]).all() and (px[[37, 42], 5] == 28).all()
    ink = (px[:10, 14:26] == 255).all(axis=-1)
    assert ink.sum() == font.text_mask("Ag").sum()


def test_font_covers_printable_ascii():
    glyphs = [font.GLYPHS[chr(c)] for c in range(32, 127)]
    assert len({g.tobytes() for g in glyphs}) == 95   # every glyph its own
    assert not glyphs[0].any() and all(g.any() for g in glyphs[1:])
    assert font.glyph("•").tobytes() == font.glyph("?").tobytes()
    assert font.text_mask("ab", 3).shape == (30, 33)


# --- PDF writer -------------------------------------------------------------

def _objects(data: bytes) -> dict[int, bytes]:
    return {int(m.group(1)): m.group(2) for m in
            re.finditer(rb"(\d+) 0 obj\n(.*?)\nendobj\n", data, re.S)}


def _stream(obj: bytes) -> bytes:
    return zlib.decompress(re.search(rb">>\nstream\n(.*)\nendstream$", obj, re.S).group(1))


def _unescape(s: bytes) -> str:
    return re.sub(rb"\\(.)", lambda m: {b"n": b"\n", b"r": b"\r"}.get(m.group(1), m.group(1)),
                  s).decode("cp1252")


def read_pdf(data: bytes) -> list[dict]:
    """Each page's MediaBox, the strings its `Tj`s show and its images, in
    the order of the page tree."""
    objs = _objects(data)
    kids = re.search(rb"/Kids \[([^\]]*)\]", objs[2]).group(1)
    pages = []
    for n in (int(k) for k in re.findall(rb"(\d+) 0 R", kids)):
        page = objs[n]
        content = _stream(objs[int(re.search(rb"/Contents (\d+) 0 R", page).group(1))])
        images = []
        for ref in re.findall(rb"/Im\d+ (\d+) 0 R", page):
            obj = objs[int(ref)]
            w = int(re.search(rb"/Width (\d+)", obj).group(1))
            h = int(re.search(rb"/Height (\d+)", obj).group(1))
            images.append(np.frombuffer(_stream(obj), np.uint8).reshape(h, w, 3))
        pages.append({
            "mediabox": tuple(float(v) for v in re.search(
                rb"/MediaBox \[([^\]]*)\]", page).group(1).split()),
            "strings": [_unescape(s) for s in
                        re.findall(rb"\(((?:\\.|[^\\)])*)\) Tj", content)],
            "images": images})
    return pages


def test_pdf_writer_xref_and_text(tmp_path):
    doc = pdf.Document()
    page = doc.add_page()
    page.rect(10, 10, 50, 20, fill="#ff0000", stroke="#000000")
    page.polyline([(0, 0), (10, 20), (30, 5)], "#00ff00", 1.2)
    page.text(100, 100, "a (b) \\ c • d — e", 9, align="center")
    page.text(50, 400, "rotated", 10, rotate=True)
    img = np.random.default_rng(1).random((6, 4, 3))
    page.image(img, 0, 0, 40, 60)
    doc.add_page(200, 100).text(0, 0, "second")
    data = doc.tobytes()
    assert data == doc.tobytes() and b"CreationDate" not in data
    assert data.startswith(b"%PDF-1.4") and data.endswith(b"%%EOF\n")
    xref = int(re.search(rb"startxref\n(\d+)\n", data).group(1))
    head, *entries = data[xref:].split(b"trailer")[0].splitlines()[1:]
    assert head == f"0 {len(entries)}".encode() and len(entries) == len(_objects(data)) + 1
    for n, entry in enumerate(entries[1:], start=1):
        assert len(entry) == 19 and entry[10:] == b" 00000 n "   # + "\n": 20 bytes
        assert data[int(entry[:10]):].startswith(f"{n} 0 obj\n".encode())
    pages = read_pdf(data)
    assert [p["mediabox"] for p in pages] == [(0, 0, 597.6, 842.4), (0, 0, 200, 100)]
    assert pages[0]["strings"] == ["a (b) \\ c • d — e", "rotated"]
    np.testing.assert_array_equal(pages[0]["images"][0], np.round(img * 255))
    assert b"/Encoding /WinAnsiEncoding" in data and b"/BaseFont /Helvetica" in data


def test_text_width_matches_helvetica_metrics():
    """The width table against the Helvetica AFM that matplotlib ships,
    by glyph name where WinAnsi and the AFM's encoding differ."""
    import os

    from matplotlib._afm import AFM

    path = os.path.join(matplotlib.get_data_path(), "fonts", "afm", "phvr8a.afm")
    with open(path, "rb") as f:
        afm = AFM(f)
    names = {39: "quotesingle", 96: "grave", 0x95: "bullet", 0x96: "endash",
             0x97: "emdash"}
    for code in [*range(32, 127), *names]:
        want = (afm.get_width_from_char_name(names[code]) if code in names
                else afm.get_width_char(chr(code)))
        got = pdf.text_width(bytes([code]).decode("cp1252"), 1000)
        assert got == want, (code, got, want)


# --- the BCA report's arrays --------------------------------------------------

def test_report_arrays_match_reference(builders):
    ref, got, (ct, _, _, tissues, _) = builders
    for axis in (0, 1):
        d_ref = jplots.tissue_densities(tissues, axis)
        d_got = tplots.tissue_densities(tissues, axis)
        np.testing.assert_allclose(d_got, d_ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tplots.heatmap_rgb(d_got), jplots.heatmap_rgb(d_ref),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tplots.tissue_heatmap(tissues, axis),
                                   jplots.tissue_heatmap(tissues, axis), rtol=0, atol=1e-6)
    idx = [0, 7, 50, 119]
    np.testing.assert_allclose(tplots.axial_overlay(ct[:, :, idx], tissues[:, :, idx]),
                               jplots.axial_overlay(ct[:, :, idx], tissues[:, :, idx]),
                               rtol=0, atol=1e-6)
    assert tplots.TISSUE_COLORS == jplots.TISSUE_COLORS


def test_table_cells_read_as_reference():
    assert [tplots._cell(v) for v in (1.234, 3, -0.005, None, "x", float("nan"), True)] == \
        ["1.23", "3.00", "-0.01", "-", "-", "nan", "1.00"]


# --- the BCA report against the reference's --------------------------------

def _reference_pdf(monkeypatch, builder, prepared) -> tuple[bytes, list[list[str]]]:
    """The reference's PDF, and each page's strings: every non-empty Text of
    its figure (tick labels and offsets excepted) split into lines, and
    every table cell."""
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.text import Text

    pages = []
    savefig = PdfPages.savefig

    def recording(self, figure=None, **kw):
        ticks = set()
        for ax in figure.axes:
            for axis in (ax.xaxis, ax.yaxis):
                for t in axis.get_major_ticks() + axis.get_minor_ticks():
                    ticks.update({id(t.label1), id(t.label2)})
                ticks.add(id(axis.offsetText))
        texts = [t.get_text() for t in figure.findobj(Text)
                 if id(t) not in ticks and t.get_text()]
        for ax in figure.axes:
            for table in ax.tables:
                texts += [cell.get_text().get_text() for cell in table.get_celld().values()]
        pages.append([line for t in texts for line in t.split("\n")])
        return savefig(self, figure, **kw)

    monkeypatch.setattr(PdfPages, "savefig", recording)
    return builder.create_pdf(**prepared), pages


@pytest.fixture(scope="module")
def reports(builders):
    """Both packages' prepare (with vertebra windows, one of them one slice
    long) and the port's PDF rendered with the CT gone, as the HostWorker
    would render it."""
    ref, got, _ = builders
    ref_prep = ref.prepare(VERTEBRAE)
    got_prep = got.prepare(VERTEBRAE)
    ct = got._ct
    got._ct = None
    try:
        data = got.create_pdf(**got_prep)
    finally:
        got._ct = ct
    return ref, ref_prep, data, got_prep


def test_report_pdf_structure_and_text(reports, monkeypatch):
    ref, ref_prep, data, _ = reports
    ref_data, ref_pages = _reference_pdf(monkeypatch, ref, ref_prep)
    n_pages = data.count(b"/Type /Page") - data.count(b"/Type /Pages")
    n_aggs = len(ref_prep["aggregated_measurements"])
    assert n_pages == ref_data.count(b"/Type /Page") - ref_data.count(b"/Type /Pages") \
        == 3 + n_aggs == len(ref_pages)
    pages = read_pdf(data)
    assert {p["mediabox"] for p in pages} == {(0.0, 0.0, 597.6, 842.4)}
    ref_box = re.search(rb"/MediaBox \[\s*([^\]]*)\]", ref_data).group(1).split()
    assert tuple(float(v) for v in ref_box) == (0.0, 0.0, 597.6, 842.4)
    for i, (page, want) in enumerate(zip(pages, ref_pages)):
        missing = Counter(want) - Counter(page["strings"])
        assert not missing, (i, missing)
    flat = [s for p in ref_pages for s in p]
    # what the check covered: the title, the legend, the findings, every
    # table's labels and cells, the one-slice window's "-"
    assert any(s.startswith("Body Composition Analysis (boa-tpu") for s in flat)
    assert any(s.startswith("  • ") for s in flat) and "Secondary findings:" in flat
    assert {"Muscle", "EAT", "MeanHU", "Maximum", "-", "L1 (slices 40-41)",
            "L1 — NoExtremities", "Slice check — tissue overlay"} <= set(flat)
    assert sum(bool(re.fullmatch(r"-?\d+\.\d\d", s)) for s in flat) > 500


def test_report_pdf_images_match_reference(reports):
    ref, ref_prep, data, _ = reports
    pages = read_pdf(data)

    def u8(a):
        return np.round(np.clip(a, 0, 1) * 255).astype(np.uint8)

    dens = ref_prep["tissue_density"]
    want = [[u8(np.rot90(jplots.heatmap_rgb(dens[axis]))) for axis in (1, 0)]]
    sc = ref_prep["equidistant_slice_check"]
    over = jplots.axial_overlay(sc["ct_slices"], sc["tissue_slices"])
    n_chk = len(sc["check_idxs"])
    want.append([u8(np.rot90(over[:, :, k])) for k in range(n_chk)])
    want += [[u8(np.rot90(over[:, :, n_chk + j]))]
             for j in range(len(ref_prep["aggregated_measurements"]))]
    assert not pages[0]["images"]
    assert [len(p["images"]) for p in pages[1:]] == [len(w) for w in want]
    for page, imgs in zip(pages[1:], want):
        for got_img, want_img in zip(page["images"], imgs):
            np.testing.assert_array_equal(got_img, want_img)


def test_report_pdf_dark_theme(reports):
    _, _, light, got_prep = reports

    class Dark:
        theme = "dark"

    dark = tplots.render_report_pdf(Dark(), got_prep, "0.1.0")
    first = zlib.decompress(re.search(rb"stream\n(.*?)\nendstream", dark, re.S).group(1))
    assert first.startswith(b"q 0.11 0.11 0.11 rg 0 0 597.6 842.4 re f Q")   # #1c1c1c
    assert b"q 1 1 1 rg BT /F1 12 Tf" in first    # white titles
    assert read_pdf(dark)[0]["strings"] == read_pdf(light)[0]["strings"]
