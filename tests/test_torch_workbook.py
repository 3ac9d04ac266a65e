"""The port's workbook path against the reference's, on the CPU: the XLSX
writer and reader (boa_tpu_torch/io/xlsx.py against boa_tpu/io/xlsx.py),
the TotalSegmentator and BCA sheet builders (compute/ts_metrics.py,
compute/bca_metrics.py) on the same files from the anatomy phantom's hook,
and `write_output_workbook`.

Bars: the writer's package parts byte-identical for the same cells (the
zip's timestamps are the only bytes that differ); tables equal to the
reference's pandas frames with numbers within rel 1e-3 / abs 1e-6
(tests/test_golden_regression.py's bar), None where pandas has NaN.
"""

import math
import zipfile

import numpy as np
import pandas as pd
import pytest

from boa_tpu.commands import write_output_workbook as jwrite
from boa_tpu.compute import bca_metrics as jbca
from boa_tpu.compute import inference as jinf
from boa_tpu.compute import ts_metrics as jts
from boa_tpu.io import xlsx as jx
from boa_tpu.testing import anatomy as janat
from boa_tpu_torch.commands import write_output_workbook
from boa_tpu_torch.compute import bca_metrics as tbca
from boa_tpu_torch.compute import geometry as tgeo
from boa_tpu_torch.compute import inference as tinf
from boa_tpu_torch.compute import ts_metrics as tts
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.io import xlsx as tx
from boa_tpu_torch.testing import anatomy as tanat


def _cells(seed):
    """A seeded mix of every cell kind the writer handles."""
    rng = np.random.default_rng(seed)
    pool = [None, float("nan"), float("inf"), -float("inf"), np.float32("nan"), True, False,
            np.bool_(True), 0, -7, np.int64(12), np.uint8(200), 1.5, np.float64(-2.25e-9),
            np.float32(3.75), "plain", "a < b & c > \"d\"", "  lead space", "ünïcode"]
    return [[pool[i] for i in rng.integers(0, len(pool), int(rng.integers(0, 9)))]
            for _ in range(12)]


def _parts(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _same_sheets(a, b):
    assert list(a) == list(b)
    for name in a:
        assert len(a[name]) == len(b[name]), name
        for ra, rb in zip(a[name], b[name]):
            assert len(ra) == len(rb), (name, ra, rb)
            for x, y in zip(ra, rb):
                assert type(x) is type(y), (name, x, y)
                assert x == y, (name, x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_writer_parts_identical(tmp_path, seed):
    """The same rows, formats and merges through both writers: every package
    part byte-identical; each reader reads both files alike."""
    books = []
    for mod in (jx, tx):
        wb = mod.Workbook()
        for s in range(2):
            sheet = wb.add_sheet(f"sheet {s} <&>")
            sheet.add_row(["head", "er", 3], mod.FMT_BOLD)
            for row in _cells(seed * 10 + s):
                sheet.add_row(row)
            sheet.add_row([None, float("nan"), "banner"], mod.FMT_WARNING)
            sheet.merge_row(len(sheet.rows) - 1, 0, 2)
            sheet.merge_row(0, 1, 27)
        wb.add_sheet("empty")
        books.append(wb)
    books[0].save(tmp_path / "ref.xlsx")
    books[1].save(tmp_path / "port.xlsx")
    assert _parts(tmp_path / "port.xlsx") == _parts(tmp_path / "ref.xlsx")
    want = jx.read_xlsx(tmp_path / "ref.xlsx")
    _same_sheets(jx.read_xlsx(tmp_path / "port.xlsx"), want)
    _same_sheets(tx.read_xlsx(tmp_path / "ref.xlsx"), want)
    assert want["sheet 0 <&>"][0] == ["head", "er", 3]


def test_add_table_matches_add_dataframe(tmp_path):
    """`add_table(columns, rows)` writes what `add_dataframe` wrote for an
    object frame of the same cells, with and without `startrow`; the
    pandas-free table reader gives `read_xlsx_sheet_df`'s columns and rows."""
    cells = _cells(7)
    width = max(len(r) for r in cells)
    rows = [r + [None] * (width - len(r)) for r in cells]
    columns = [f"C{i}" for i in range(width)]
    frame = pd.DataFrame(rows, columns=columns, dtype=object)
    jwb, twb = jx.Workbook(), tx.Workbook()
    for start in (0, 2):
        jwb.add_dataframe(frame, f"t{start}", startrow=start)
        twb.add_table(columns, rows, f"t{start}", startrow=start)
    jwb.save(tmp_path / "ref.xlsx")
    twb.save(tmp_path / "port.xlsx")
    assert _parts(tmp_path / "port.xlsx") == _parts(tmp_path / "ref.xlsx")
    df = jx.read_xlsx_sheet_df(tmp_path / "ref.xlsx", "t2", header_row=2)
    cols, got = tx.read_xlsx_sheet_table(tmp_path / "port.xlsx", "t2", header_row=2)
    assert cols == list(df.columns)
    assert [[None if isinstance(v, float) and math.isnan(v) else v for v in r]
            for r in df.itertuples(index=False)] == got


@pytest.mark.parametrize("seed", [0, 1])
def test_records_table_matches_pandas(seed):
    """`records_table` lays out a list of dicts as `pd.DataFrame(records)`:
    the same column order, None where pandas has NaN."""
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(8)]
    records = [{k: float(rng.normal()) if rng.random() < 0.5 else str(k)
                for k in rng.permutation(keys)[:rng.integers(1, 8)]} for _ in range(20)]
    columns, rows = tx.records_table(records)
    df = pd.DataFrame(records)
    assert columns == list(df.columns)
    assert rows == [[None if isinstance(v, float) and math.isnan(v) else v for v in r]
                    for r in df.itertuples(index=False)]


def _frame_rows(df):
    return list(df.columns), [[None if isinstance(v, float) and math.isnan(v) else v
                               for v in r] for r in df.itertuples(index=False)]


def _same_table(got, want_df):
    columns, rows = got
    want_cols, want_rows = _frame_rows(want_df)
    assert columns == want_cols
    assert len(rows) == len(want_rows)
    for g, w in zip(rows, want_rows):
        for a, b in zip(g, w, strict=True):
            if isinstance(b, (float, int, np.number)) and not isinstance(b, (bool, np.bool_)):
                assert a == pytest.approx(b, rel=1e-3, abs=1e-6), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def phantom_run(tmp_path_factory):
    """`total` (fast) and `bca` through the anatomy phantom's hook, in both
    packages, from tests/test_cli_e2e.py's phantom CT file (CNR adjustment
    on, so that the cnr-adjusted sheet has rows)."""
    root = tmp_path_factory.mktemp("phantom")
    shape, spacing = (160, 160, 48), (2.5, 2.5, 6.0)
    tn.save(tn.NiftiImage(data=tanat.synth_ct(shape, spacing),
                          affine=np.diag([*spacing, 1.0])), root / "ct.nii.gz")
    kw = dict(totalsegmentator_params={"fast": True}, bca_params={"save_pdf": False},
              cnr_adjustment=True)
    ref_images: dict = {}
    jinf.compute_all_models(root / "ct.nii.gz", root / "ref", ["total", "bca"],
                            fake_predict=janat.fake_predict_factory(),
                            images_out=ref_images, **kw)
    images: dict = {}
    tinf.compute_all_models(root / "ct.nii.gz", root / "got", ["total", "bca"],
                            fake_predict=tanat.fake_predict_factory(), device="cpu",
                            images_out=images, **kw)
    return root, ref_images, images


@pytest.mark.parametrize("in_memory", [False, True])
def test_segmentator_metrics_match_reference(phantom_run, in_memory):
    """The info rows, regions-statistics and cnr-adjusted tables from the
    same files, with the label images in memory (body-cropped, padded back)
    or reloaded from disk."""
    root, ref_images, images = phantom_run
    info, regions, cnr = tts.compute_segmentator_metrics(
        root / "ct.nii.gz", root / "ref", seg_images=images if in_memory else None)
    winfo, wregions, wcnr = jts.compute_segmentator_metrics(
        root / "ct.nii.gz", root / "ref", seg_images=ref_images if in_memory else None)
    assert [r["name"] for r in info] == [r["name"] for r in winfo]
    assert [r["value"] for r in info] == pytest.approx([r["value"] for r in winfo],
                                                       rel=1e-3, abs=1e-6)
    assert {"Noise", "CNRAorta", "MaxAxisL3_cm", "MeanAxisL3_cm"} <= {r["name"] for r in info}
    _same_table(regions, wregions)
    _same_table(cnr, wcnr)
    assert len(cnr[1]) == 3 and regions[1][0][:3] == ["CerebralBleed", None, False]


def test_bca_metrics_match_reference(phantom_run):
    root, _, _ = phantom_run
    got = tbca.compute_bca_metrics(root / "got")
    for table, want in zip(got, jbca.compute_bca_metrics(root / "ref"), strict=True):
        _same_table(table, want)
    assert got[0][0][:3] == ["BodyPart", "Present", "AggregationType"]
    assert len(got[1][1]) == 48


def test_bca_metrics_empty_groups_and_slices(tmp_path):
    """No aggregation group and no slice: the absent rows, the lead columns
    and a slice table of its header alone, as the reference lays them out."""
    import json

    (tmp_path / "bca-measurements.json").write_text(json.dumps(
        {"aggregated": {}, "slices": [], "slices_no_extremities": []}))
    got = tbca.compute_bca_metrics(tmp_path)
    for table, want in zip(got, jbca.compute_bca_metrics(tmp_path), strict=True):
        _same_table(table, want)
    assert got[1] == (["SliceNumber"], [])


def test_store_axes_raises(phantom_run, tmp_path):
    """`store_axes=True`, which raised until the renderers were ported
    (ROADMAP M9 (i)), writes major_minor_axis.png as the reference does: the
    middle L3 slice in gray with the reference's major axis in green and its
    minor axis in blue (a point a quarter along each), and the same info
    rows."""
    import shutil

    from PIL import Image

    from boa_tpu.compute.geometry import find_axes
    from boa_tpu.tasks.class_maps import get_class_map

    root, _, _ = phantom_run
    for name in ("got", "ref"):
        shutil.copytree(root / name, tmp_path / name)
    info = tts.compute_segmentator_metrics(root / "ct.nii.gz", tmp_path / "got",
                                           store_axes=True)[0]
    winfo = jts.compute_segmentator_metrics(root / "ct.nii.gz", tmp_path / "ref",
                                            store_axes=True)[0]
    assert [r["name"] for r in info] == [r["name"] for r in winfo]
    assert [r["value"] for r in info] == pytest.approx([r["value"] for r in winfo],
                                                       rel=1e-3, abs=1e-6)
    assert (tmp_path / "ref" / "major_minor_axis.png").stat().st_size > 1000
    with Image.open(tmp_path / "got" / "major_minor_axis.png") as im:
        rgb = np.asarray(im)
    total = tn.load(tmp_path / "got" / "total.nii.gz").data
    body = tn.load(tmp_path / "got" / "body_parts.nii.gz").data
    l3 = {v: k for k, v in get_class_map("total").items()}["vertebrae_L3"]
    zs = np.where((total == l3).any(axis=(0, 1)))[0]
    middle = body[:, :, int(np.median(zs))] == 1
    assert max(rgb.shape[:2]) == 740 and rgb.shape[2] == 3
    scale = rgb.shape[0] / middle.shape[0]
    assert rgb.shape[1] == round(middle.shape[1] * scale)
    major_a, major_b, minor_a, minor_b = find_axes(middle)
    for (a, b), color in (((major_a, major_b), [0, 128, 0]), ((minor_a, minor_b), [0, 0, 255])):
        col, row = (a + 0.25 * (b - a) + 0.5) * scale
        assert (rgb[int(row), int(col)] == color).all()
        assert (rgb == color).all(axis=-1).sum() > 1000
    assert set(np.unique(rgb[..., 0])) <= {0, 255}   # the mask in gray: black, white


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_find_axes_matches_reference(seed):
    """Random ellipses with a notch: the same four endpoints."""
    from boa_tpu.compute import geometry as jgeo

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:96, :112]
    a, b = rng.uniform(20, 45, 2)
    mask = ((x - 56) / a) ** 2 + ((y - 48) / b) ** 2 < 1
    mask[40:44, : int(rng.integers(20, 60))] = False
    for g, w in zip(tgeo.find_axes(mask), jgeo.find_axes(mask), strict=True):
        np.testing.assert_array_equal(g, w)


def test_write_output_workbook_matches_reference(phantom_run, tmp_path):
    """The six sheets from the same tables: package parts byte-identical
    where pandas keeps the cells' types (the info sheet, the warning row, its
    merge), and every sheet read back equal within the bars."""
    root, _, _ = phantom_run
    info = [{"name": "BOAVersion", "value": "0.1.0"}, {"name": "Noise", "value": 10.5},
            {"name": "PredictedContrastInGIT", "value": True}]
    _, regions, cnr = tts.compute_segmentator_metrics(root / "ct.nii.gz", root / "got")
    bca = tbca.compute_bca_metrics(root / "got")
    write_output_workbook(tmp_path / "port.xlsx", info, regions, cnr, *bca)
    _, wregions, wcnr = jts.compute_segmentator_metrics(root / "ct.nii.gz", root / "ref")
    jwrite(tmp_path / "ref.xlsx", pd.DataFrame(info).set_index("name"), wregions, wcnr,
           *jbca.compute_bca_metrics(root / "ref"))
    got, want = tx.read_xlsx(tmp_path / "port.xlsx"), jx.read_xlsx(tmp_path / "ref.xlsx")
    assert list(got) == list(want) == [
        "info", "regions-statistics", "cnr-adjusted", "bca-aggregated-measurements",
        "bca-slice-measurements", "bca-slice-measurements_no_ext"]
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            assert g == pytest.approx(w, rel=1e-3, abs=1e-6), (name, g, w)
    port, ref = _parts(tmp_path / "port.xlsx"), _parts(tmp_path / "ref.xlsx")
    for part in ("xl/worksheets/sheet1.xml", "xl/workbook.xml", "xl/styles.xml"):
        assert port[part] == ref[part], part
    assert b'<mergeCell ref="A1:K1"/>' in port["xl/worksheets/sheet3.xml"]
