"""The port's DICOM-SEG and Encapsulated-PDF writers
(boa_tpu_torch/io/dicom_seg.py) against the reference's
(boa_tpu/io/dicom_seg.py) on the same labels and CT headers: every element
equal apart from UIDs, dates and times, PixelData (bit-packed frames per
segment and slice) equal byte for byte, the file read back by both parsers;
`read_seg_labelmap` round trips; `write_encapsulated_pdf` on the port's BCA
report.pdf."""

import numpy as np
import pytest

from boa_tpu.io import dicom as jd
from boa_tpu.io import dicom_io as jio
from boa_tpu.io import dicom_seg as jseg
from boa_tpu.io.nifti import NiftiImage
from boa_tpu_torch.io import dicom as td
from boa_tpu_torch.io import dicom_seg as tseg
from tests.test_bca import synthetic_study  # noqa: F401 (fixture)
from tests.test_torch_bca import VERTEBRAE, builders  # noqa: F401 (fixture)

_VOLATILE = {"SOPInstanceUID", "SeriesInstanceUID", "MediaStorageSOPInstanceUID",
             "DimensionOrganizationUID", "SeriesDate", "SeriesTime", "ContentDate",
             "ContentTime"}


def _same_dataset(got, want, path=""):
    keys = sorted(want.keys())
    assert sorted(got.keys()) == keys, path
    for tag in keys:
        kw = jd.TAG_TO_KEYWORD.get(tag, str(tag))
        if kw in _VOLATILE:
            continue
        g, w = got.get(tag), want.get(tag)
        if isinstance(w, list) and w and hasattr(w[0], "keys"):
            assert len(g) == len(w), f"{path}/{kw}"
            for i, (a, b) in enumerate(zip(g, w)):
                _same_dataset(a, b, f"{path}/{kw}[{i}]")
        else:
            assert type(g) is type(w) and g == w, f"{path}/{kw}"


def _headers(tmp_path, shape):
    img = NiftiImage(data=np.full(shape, -1000, np.int16),
                     affine=np.diag([-0.9, -0.9, 2.0, 1.0]))
    files = sorted(jio.write_ct_series(img, tmp_path / "series"))
    return ([jd.dcmread(f, stop_before_pixels=True) for f in files],
            [td.dcmread(f, stop_before_pixels=True) for f in files])


def _labels(seed, shape):
    rng = np.random.default_rng(seed)
    seg = np.zeros(shape, np.uint8)
    seg[4:12, 5:15, 2:6] = 1
    seg[20:28, 10:20, 4:11] = 3
    seg[rng.random(shape) > 0.995] = 7
    seg[0, 0, shape[2] - 1] = 9   # not in the label map: no segment
    return seg


@pytest.mark.parametrize("skip_empty", [True, False])
@pytest.mark.parametrize("colors", [None, {1: (200, 30, 30), 7: (30, 30, 200)}])
def test_write_multiclass_seg_equal(tmp_path, skip_empty, colors):
    shape = (32, 28, 12)
    jh, th = _headers(tmp_path, shape)
    seg = _labels(0, shape)
    names = {1: "liver", 3: "spleen", 7: "aorta", 11: "absent"}
    want = jseg.write_multiclass_seg(seg, names, jh, "Total Body Segmentation",
                                     colors=colors, skip_empty_slices=skip_empty)
    got = tseg.write_multiclass_seg(seg, names, th, "Total Body Segmentation",
                                    colors=colors, skip_empty_slices=skip_empty)
    _same_dataset(got, want)
    assert got.get("PixelData") == want.get("PixelData")
    assert int(got.NumberOfFrames) == int(want.NumberOfFrames)
    td.dcmwrite(tmp_path / "seg.dcm", got)
    back_t, back_j = td.dcmread(tmp_path / "seg.dcm"), jd.dcmread(tmp_path / "seg.dcm")
    assert back_t.get("PixelData") == back_j.get("PixelData") == want.get("PixelData")


def test_read_seg_labelmap_round_trip(tmp_path):
    """Segments renumbered 1..n, only the slices holding a segment, the
    same volume and names from both readers."""
    shape = (32, 28, 12)
    _, th = _headers(tmp_path, shape)
    seg = _labels(1, shape)
    names = {1: "liver", 3: "spleen", 7: "aorta"}
    ds = tseg.write_multiclass_seg(seg, names, th, "seg")
    back, seg_names = tseg.read_seg_labelmap(ds)
    expect = np.zeros_like(seg, dtype=np.uint16)
    for i, lb in enumerate(sorted(names), start=1):
        expect[seg == lb] = i
    zs = sorted(set(np.where(np.isin(seg, list(names)).any(axis=(0, 1)))[0]))
    np.testing.assert_array_equal(back, expect[:, :, zs])
    assert seg_names == {1: "liver", 2: "spleen", 3: "aorta"}
    ref_back, ref_names = jseg.read_seg_labelmap(ds)
    np.testing.assert_array_equal(back, ref_back)
    assert seg_names == ref_names


def test_slice_labels_table():
    seg = _labels(2, (10, 9, 8))
    table = tseg.slice_labels(seg, 7)
    for z in range(8):
        for lb in range(8):
            assert table[z, lb] == (seg[:, :, z] == lb).any()


def test_errors_as_reference(tmp_path):
    shape = (16, 16, 4)
    jh, th = _headers(tmp_path, shape)
    empty = np.zeros(shape, np.uint8)
    for mod, hdrs in ((jseg, jh), (tseg, th)):
        with pytest.raises(ValueError, match="empty"):
            mod.write_multiclass_seg(empty, {1: "liver"}, hdrs, "seg")
        with pytest.raises(ValueError, match="slices"):
            mod.write_multiclass_seg(empty[:, :, :3], {1: "liver"}, hdrs, "seg")


def test_encapsulated_pdf_of_the_report(tmp_path, builders):  # noqa: F811
    """The port's BCA report.pdf as an Encapsulated PDF: the same elements
    as the reference's, the document bytes (padded to even length) intact
    after a write and a read by either parser."""
    _, got_builder, _ = builders
    pdf = got_builder.create_pdf(**got_builder.prepare(VERTEBRAE))
    assert pdf.startswith(b"%PDF")
    jh, th = _headers(tmp_path, (16, 16, 2))
    want = jseg.write_encapsulated_pdf(pdf, jh[0])
    got = tseg.write_encapsulated_pdf(pdf, th[0])
    _same_dataset(got, want)
    td.dcmwrite(tmp_path / "report.dcm", got)
    for back in (td.dcmread(tmp_path / "report.dcm"), jd.dcmread(tmp_path / "report.dcm")):
        doc = back.get("EncapsulatedDocument")
        assert doc[:len(pdf)] == pdf and len(doc) == len(pdf) + len(pdf) % 2
        assert back.MIMETypeOfEncapsulatedDocument == "application/pdf"
        assert back.Modality == "DOC"
