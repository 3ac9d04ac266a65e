"""The port's contour tracer (boa_tpu_torch/compute/geometry.py
`find_contours`) and RTSTRUCT writer (boa_tpu_torch/io/rtstruct.py) against
the reference's, whose `_slice_contours` calls `cv2.findContours(...,
RETR_CCOMP, CHAIN_APPROX_SIMPLE)`. Cases: 1-pixel lines, diagonal-only
contact, holes inside holes, masks touching the slice edge, single pixels
(fewer than 3 points: dropped), and seeded random masks. Bars: through
`_slice_contours` the same set of contours, each equal up to a cyclic shift
of its start point; against `cv2.findContours` itself the same list (order,
start points, points); the two RTSTRUCTs' ContourData equal element for
element, and every other element equal apart from UIDs, dates and times."""

import cv2
import numpy as np
import pytest
from scipy import ndimage

from boa_tpu.io import dicom as jd
from boa_tpu.io import dicom_io as jio
from boa_tpu.io import rtstruct as jrt
from boa_tpu.io.nifti import NiftiImage
from boa_tpu_torch.compute.geometry import find_contours
from boa_tpu_torch.io import dicom as td
from boa_tpu_torch.io import rtstruct as trt


def _case(name):
    if name == "hline":
        m = np.zeros((7, 9), np.uint8)
        m[3, 2:7] = 1
    elif name == "vline_edge":
        m = np.zeros((7, 9), np.uint8)
        m[0:7, 0] = 1
    elif name == "diagonal":
        m = np.eye(7, dtype=np.uint8)
    elif name == "diagonal_contact":
        m = np.zeros((8, 8), np.uint8)
        m[1:3, 1:3] = m[3:5, 3:5] = m[5, 5] = m[2, 6] = 1
    elif name == "pixel":
        m = np.zeros((5, 5), np.uint8)
        m[2, 2] = 1
    elif name == "two_pixels":
        m = np.zeros((5, 5), np.uint8)
        m[2, 1:3] = 1
    elif name == "ring_island":
        m = np.ones((9, 9), np.uint8)
        m[2:7, 2:7] = 0
        m[4, 4] = 1
    elif name == "holes_in_holes":
        m = np.ones((15, 15), np.uint8)
        m[2:13, 2:13] = 0
        m[4:11, 4:11] = 1
        m[6:9, 6:9] = 0
        m[7, 7] = 1
    elif name == "edge_touching":
        m = np.zeros((10, 12), np.uint8)
        m[:4, :] = 1
        m[6:, 9:] = 1
        m[1, 3] = 0
    elif name == "full":
        m = np.ones((6, 7), np.uint8)
    elif name == "checker":
        m = (np.indices((9, 9)).sum(0) % 2).astype(np.uint8)
    elif name.startswith("speckle"):
        rng = np.random.default_rng(int(name[7:]))
        h, w = rng.integers(1, 40, 2)
        m = (rng.random((h, w)) > rng.uniform(0.2, 0.8)).astype(np.uint8)
    elif name.startswith("blob"):
        rng = np.random.default_rng(int(name[4:]))
        m = (ndimage.gaussian_filter(rng.random((90, 80)), 3) > 0.5).astype(np.uint8)
    else:
        raise KeyError(name)
    return m


CASES = ["hline", "vline_edge", "diagonal", "diagonal_contact", "pixel", "two_pixels",
         "ring_island", "holes_in_holes", "edge_touching", "full", "checker"] + \
    [f"speckle{i}" for i in range(6)] + [f"blob{i}" for i in range(4)]


def _cyclic_key(c):
    """The lexicographically smallest rotation of a point cycle."""
    pts = [tuple(p) for p in np.asarray(c, np.int64).reshape(-1, 2).tolist()]
    return min(tuple(pts[i:] + pts[:i]) for i in range(len(pts)))


@pytest.mark.parametrize("name", CASES)
def test_slice_contours_equal_to_cv2_up_to_start(name):
    m = _case(name).T   # _slice_contours takes an (x, y) mask
    want = jrt._slice_contours(m)
    got = trt._slice_contours(m)
    assert sorted(map(_cyclic_key, got)) == sorted(map(_cyclic_key, want))
    assert all(c.dtype == np.float64 and len(c) >= 3 for c in got)


def test_find_contours_is_cv2_ccomp_simple():
    """The same list as OpenCV: order (outer borders last found first, each
    followed by its holes), start points and points, on the named cases and
    on 500 seeded random masks."""
    rng = np.random.default_rng(0)
    masks = [_case(n) for n in CASES]
    for _ in range(500):
        h, w = rng.integers(1, 32, 2)
        masks.append((rng.random((h, w)) > rng.uniform(0.2, 0.8)).astype(np.uint8))
    for m in masks:
        want, _ = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)
        got = find_contours(m)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_find_contours_empty_and_dimensions():
    assert find_contours(np.zeros((4, 5), bool)) == []
    with pytest.raises(ValueError):
        find_contours(np.zeros((2, 2, 2), bool))


def _series(tmp_path, shape=(40, 36, 6)):
    img = NiftiImage(data=np.full(shape, -1000, np.int16),
                     affine=np.diag([-0.8, -0.7, 2.5, 1.0]))
    img.affine[:3, 3] = (12.0, -30.0, 100.0)
    files = jio.write_ct_series(img, tmp_path / "series")
    return [jd.dcmread(f, stop_before_pixels=True) for f in sorted(files)], \
        [td.dcmread(f, stop_before_pixels=True) for f in sorted(files)]


_VOLATILE = {"SOPInstanceUID", "SeriesInstanceUID", "MediaStorageSOPInstanceUID",
             "StructureSetDate", "StructureSetTime"}


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
            assert g == w, f"{path}/{kw}"


def test_write_rtstruct_equal(tmp_path):
    """Both packages' RTSTRUCT on the same labels (a ring with an island, a
    slice-edge block, speckle, a single pixel that is dropped) and headers;
    the port's file reads back through the reference's parser."""
    jh, th = _series(tmp_path)
    rng = np.random.default_rng(3)
    seg = np.zeros((40, 36, 6), np.uint8)
    seg[5:25, 4:24, 1:5] = 1
    seg[9:21, 8:20, 1:5] = 0
    seg[13:16, 12:15, 2:4] = 1
    seg[30:40, 0:10, :] = 2
    seg[rng.random(seg.shape) > 0.97] = 4
    seg[2, 33, 0] = 5
    labels = {1: "liver", 2: "spleen", 4: "aorta", 5: "lonely", 6: "absent"}
    colors = {1: (200, 30, 30), 2: (30, 200, 30)}
    want = jrt.write_rtstruct(seg, labels, jh, colors=colors)
    spans = {}
    got = trt.write_rtstruct(seg, labels, th, colors=colors, spans=spans)
    _same_dataset(got, want)
    roi_names = [r.ROIName for r in got.StructureSetROISequence]
    assert roi_names == ["liver", "spleen", "aorta", "lonely"]
    for rc_g, rc_w in zip(got.ROIContourSequence, want.ROIContourSequence):
        assert len(rc_g.ContourSequence) == len(rc_w.ContourSequence)
        for a, b in zip(rc_g.ContourSequence, rc_w.ContourSequence):
            assert a.ContourData == b.ContourData   # element for element
    assert spans["contours"] > 0
    td.dcmwrite(tmp_path / "rt.dcm", got)
    back = jd.dcmread(tmp_path / "rt.dcm")
    assert [r.ROIName for r in back.StructureSetROISequence] == roi_names
    assert back.Modality == "RTSTRUCT"
    assert (tmp_path / "rt.dcm").read_bytes() == td.dataset_bytes(got)
