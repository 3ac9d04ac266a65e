"""The port's DICOM ingestion against the reference's, on the CPU.

`boa_tpu_torch/io/{dicom,dicom_codecs,dicom_io,imageio}.py` and the host
decoders of `boa_tpu_torch/native/` (built with g++ at first use) against
`boa_tpu/io/` and `boa_tpu/native`: the cases of tests/test_dicom.py that
ingestion covers, run through the port, and the same seeded inputs through
both packages. Bars: volumes, decoded frames, written files and metadata
rows equal (bit for bit); affines within 1e-6; lossy JPEG within the
reference test's bounds and equal across packages.
"""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from boa_tpu import native as jnative
from boa_tpu.io import dicom as jd
from boa_tpu.io import dicom_codecs as jc
from boa_tpu.io import dicom_io as jio
from boa_tpu.io import imageio as jimg
from boa_tpu.io import nifti as jn
from boa_tpu_torch import native as tnative
from boa_tpu_torch.io import dicom as td
from boa_tpu_torch.io import dicom_codecs as tc
from boa_tpu_torch.io import dicom_io as tio
from boa_tpu_torch.io import imageio as timg
from boa_tpu_torch.io import nifti as tn

ROOT = Path(__file__).resolve().parents[1]
LOSSLESS = ["RLE_LOSSLESS", "JPEG_LOSSLESS_SV1", "JPEG_LS_LOSSLESS", "JPEG_2000_LOSSLESS"]


@pytest.fixture()
def ct_image():
    """tests/test_dicom.py's volume, from its own seed."""
    data = np.random.default_rng(0).integers(-1000, 1500, size=(32, 28, 12)).astype(np.int16)
    affine = np.diag([-0.7, -0.7, 2.5, 1.0])
    affine[:3, 3] = (100.0, 80.0, -50.0)
    return tn.NiftiImage(data=data, affine=affine)


@pytest.fixture()
def series_dir(ct_image, tmp_path):
    tio.write_ct_series(ct_image, tmp_path / "dicoms",
                        extra={"KVP": 120.0, "XRayTubeCurrent": 200})
    return tmp_path / "dicoms"


def _ct_slice(rng, rows=64, cols=64):
    """tests/test_dicom.py's synthetic CT-like slice: smooth anatomy and
    noise, int16 HU."""
    yy, xx = np.mgrid[:rows, :cols]
    body = (((xx - cols / 2) / (cols * 0.4)) ** 2
            + ((yy - rows / 2) / (rows * 0.45)) ** 2) <= 1.0
    img = np.full((rows, cols), -1000, np.int16)
    img[body] = (40 + 30 * np.sin(xx[body] / 5.0)
                 + rng.normal(0, 12, body.sum())).astype(np.int16)
    return img


def _fixed_uids(monkeypatch):
    """Both packages' generate_uid made deterministic: the random branch
    (the frame of reference UID) hashes a fixed string instead."""
    for mod in (td, jd):
        real = mod.generate_uid

        def fixed(entropy_srcs=None, prefix=mod.PYDICOM_ROOT_UID, real=real):
            return real(entropy_srcs=entropy_srcs or ["frame-of-reference"], prefix=prefix)

        monkeypatch.setattr(mod, "generate_uid", fixed)


# ------------------------------------------------------------------ series


def test_series_roundtrip(ct_image, series_dir):
    """The port's series reads back voxel-identical in both packages, with
    the same affine and header."""
    img, files, hdr = tio.read_series(series_dir)
    ref, ref_files, ref_hdr = jio.read_series(series_dir)
    assert len(files) == 12 and [f.name for f in files] == [f.name for f in ref_files]
    np.testing.assert_array_equal(img.data, ct_image.data)
    np.testing.assert_array_equal(img.data, ref.data)
    assert img.data.dtype == ref.data.dtype == np.int16
    np.testing.assert_allclose(img.affine, ct_image.affine, atol=1e-6)
    np.testing.assert_array_equal(img.affine, ref.affine)
    assert hdr.Modality == "CT" and hdr.get("KVP") == 120.0
    assert hdr.get("XRayTubeCurrent") == ref_hdr.get("XRayTubeCurrent") == 200


def test_dcmread_implicit_vr(series_dir):
    """Implicit-VR-LE datasets parse through the tag dictionary, as in the
    reference."""
    ds = td.dcmread(sorted(series_dir.iterdir())[0])
    raw = bytearray()
    for kw, val in [("Modality", "CT"), ("SeriesNumber", 7)]:
        g, e, vr = td.DICT[kw]
        enc = td._encode_value(vr, val)
        assert enc == jd._encode_value(vr, val)
        raw += struct.pack("<HHI", g, e, len(enc)) + enc
    ds2 = td.dcmread(bytes(raw))
    ref = jd.dcmread(bytes(raw))
    assert ds2.Modality == ref.Modality == "CT"
    assert ds2.SeriesNumber == ref.SeriesNumber == 7
    assert ds.SOPClassUID == td.CT_IMAGE_STORAGE


@pytest.mark.parametrize("ts_attr", LOSSLESS)
def test_compressed_series_roundtrip(ct_image, tmp_path, ts_attr):
    """A series written with a compressed syntax reads back voxel-identical,
    and each package reads the other's series to the same volume."""
    ts = getattr(td, ts_attr)
    assert ts == getattr(jd, ts_attr)
    tio.write_ct_series(ct_image, tmp_path / "port", transfer_syntax=ts)
    jio.write_ct_series(jn.NiftiImage(data=ct_image.data, affine=ct_image.affine),
                        tmp_path / "ref", transfer_syntax=ts)
    first = td.dcmread(sorted((tmp_path / "port").iterdir())[0])
    assert first.file_meta.TransferSyntaxUID == ts
    for folder in ("port", "ref"):
        img, _, _ = tio.read_series(tmp_path / folder)
        ref, _, _ = jio.read_series(tmp_path / folder)
        np.testing.assert_array_equal(img.data, ct_image.data)
        np.testing.assert_array_equal(ref.data, ct_image.data)
        np.testing.assert_allclose(img.affine, ct_image.affine, atol=1e-6)
        np.testing.assert_array_equal(img.affine, ref.affine)


@pytest.mark.parametrize("ts_attr", ["EXPLICIT_VR_LE", *LOSSLESS, "JPEG_EXTENDED"])
def test_written_series_byte_identical(ct_image, tmp_path, monkeypatch, ts_attr):
    """With the study and series UIDs given and generate_uid deterministic,
    write_ct_series writes the same bytes in both packages."""
    _fixed_uids(monkeypatch)
    kw = dict(study_uid="1.2.826.0.1.3680043.8.498.1", series_uid="1.2.826.0.1.3680043.8.498.2",
              transfer_syntax=getattr(td, ts_attr), extra={"KVP": 100.0})
    got = tio.write_ct_series(ct_image, tmp_path / "port", **kw)
    want = jio.write_ct_series(jn.NiftiImage(data=ct_image.data, affine=ct_image.affine),
                               tmp_path / "ref", **kw)
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert g.read_bytes() == w.read_bytes(), g.name


def test_get_image_info(series_dir, tmp_path):
    """image.nii.gz byte-identical across packages and the metadata rows
    equal."""
    nifti_path, info = tio.get_image_info(series_dir, tmp_path / "port")
    ref_path, ref_info = jio.get_image_info(series_dir, tmp_path / "ref")
    assert nifti_path == tmp_path / "port" / "image.nii.gz"
    assert nifti_path.read_bytes() == ref_path.read_bytes()
    assert info == ref_info
    names = {r["name"] for r in info}
    assert {"StudyInstanceUID", "SeriesInstanceUID", "Modality", "KVP",
            "PixelSpacingX", "SliceThickness"} <= names
    assert next(r["value"] for r in info if r["name"] == "KVP") == 120.0


def test_extract_metadata_matches_reference(series_dir):
    """The 17-tag table with dates, the age, a multi-valued kernel and a
    scalar pixel spacing, equal to the reference's rows."""
    ds = td.dcmread(sorted(series_dir.iterdir())[0], stop_before_pixels=True)
    ref = jd.dcmread(sorted(series_dir.iterdir())[0], stop_before_pixels=True)
    for d in (ds, ref):
        d.PatientBirthDate = "19600715"
        d.SeriesDate = "20260101"
        d.ConvolutionKernel = ["B30f", "SHARP"]
        d.CTDIvol = 12.5
    assert tio.extract_metadata(ds) == jio.extract_metadata(ref)
    assert {"name": "AgeYears", "value": 65} in tio.extract_metadata(ds)
    for d in (ds, ref):
        d.PixelSpacing = 0.7
        d.SeriesDate = "garbage"
    assert tio.extract_metadata(ds) == jio.extract_metadata(ref)


def test_validate_dicom_gates(series_dir):
    """Each gate rejects with the reference's message: too few instances, not
    CT, a disqualifying ImageType, coronal, and axial but tilted."""
    ds = td.dcmread(sorted(series_dir.iterdir())[0], stop_before_pixels=True)
    ref = jd.dcmread(sorted(series_dir.iterdir())[0], stop_before_pixels=True)
    assert tio.validate_dicom(ds, 12) is None
    assert "less than 10" in tio.validate_dicom(ds, 3)
    assert tio.validate_dicom(ds, 3) == jio.validate_dicom(ref, 3)
    changes = [("Modality", "MR", "not CT"),
               ("ImageType", ["DERIVED", "SECONDARY", "LOCALIZER"], "disqualifying"),
               ("ImageOrientationPatient", [1, 0, 0, 0, 0, 1], "coronal"),
               ("ImageOrientationPatient", [1, 0, 0, 0, 0.8, 0.6], "tilted")]
    for key, value, word in changes:
        d, r = (td.dcmread(sorted(series_dir.iterdir())[0], stop_before_pixels=True),
                jd.dcmread(sorted(series_dir.iterdir())[0], stop_before_pixels=True))
        setattr(d, key, value)
        setattr(r, key, value)
        msg = tio.validate_dicom(d, 12)
        assert word in msg and msg == jio.validate_dicom(r, 12)
    for iop in ([1, 0, 0, 0, 1, 0], [0, 1, 0, 0, 0, -1], [1, 0, 0, 0, 0, 1], None):
        plane, normal = tio.classify_orientation(iop)
        want_plane, want_normal = jio.classify_orientation(iop)
        assert plane == want_plane
        assert (normal is None and want_normal is None) or \
            np.array_equal(normal, want_normal)


def test_sorted_headers_pick_the_largest_series(ct_image, tmp_path):
    """Two series in one folder and a stray file: the larger series, sorted
    along the slice normal, in both packages; an empty folder raises the
    reference's error."""
    tio.write_ct_series(ct_image, tmp_path / "mix", series_uid="1.2.3.1")
    small = tn.NiftiImage(data=ct_image.data[:, :, :4], affine=ct_image.affine)
    tio.write_ct_series(small, tmp_path / "small", series_uid="1.2.3.2")
    for p in sorted((tmp_path / "small").iterdir()):
        p.rename(tmp_path / "mix" / f"b_{p.name}")
    (tmp_path / "mix" / "notes.txt").write_text("not DICOM")
    files, headers = tio.sorted_series_headers(tmp_path / "mix")
    ref_files, _ = jio.sorted_series_headers(tmp_path / "mix")
    assert files == ref_files and len(files) == 12
    assert {h.SeriesInstanceUID for h in headers} == {"1.2.3.1"}
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No DICOM series found"):
        tio.sorted_series_headers(tmp_path / "empty")


def test_deterministic_uids():
    a = td.generate_uid(entropy_srcs=["x", "y"])
    b = td.generate_uid(entropy_srcs=["x", "y"])
    c = td.generate_uid(entropy_srcs=["x", "z"])
    assert a == b != c
    assert a == jd.generate_uid(entropy_srcs=["x", "y"])
    assert a.startswith(td.PYDICOM_ROOT_UID) and len(a) <= 64
    r1, r2 = td.generate_uid(), td.generate_uid()
    assert r1 != r2 and len(r1) <= 64


def test_cielab_and_code_item_match_reference():
    L, a, b = td.rgb_to_cielab_dicom((255, 255, 255))
    assert L == 65535
    assert abs(a - 32896) < 300 and abs(b - 32896) < 300
    assert td.rgb_to_cielab_dicom((0, 0, 0))[0] == 0
    for rgb in ((255, 0, 0), (12, 200, 77), (128, 128, 128)):
        assert td.rgb_to_cielab_dicom(rgb) == jd.rgb_to_cielab_dicom(rgb)
    ds, ref = td.code_item("10200004", "SCT", "Liver"), jd.code_item("10200004", "SCT", "Liver")
    for item in (ds, ref):
        item.SOPInstanceUID = "1.2.826.0.1.3680043.8.498.3"
    assert td.dataset_bytes(ds) == jd.dataset_bytes(ref)


def test_imageio_registry_matches_reference(ct_image, tmp_path):
    """Readers by ending (a directory is a DICOM series) in both packages;
    a series written through the port's registry reads back through the
    reference's."""
    for name in ("a.nii", "b.nii.gz", "c.npy", "d.npz", "dicoms"):
        assert type(timg.io_for_path(tmp_path / name)).__name__ == \
            type(jimg.io_for_path(tmp_path / name)).__name__
    with pytest.raises(ValueError):
        timg.io_for_path(tmp_path / "x.png")
    timg.write_image(ct_image, tmp_path / "series")
    np.testing.assert_array_equal(jimg.read_image(tmp_path / "series").data, ct_image.data)
    np.testing.assert_array_equal(timg.read_image(tmp_path / "series").data, ct_image.data)
    timg.write_image(ct_image, tmp_path / "v.npz")
    back = timg.read_image(tmp_path / "v.npz")
    np.testing.assert_array_equal(back.data, ct_image.data)
    np.testing.assert_array_equal(back.affine, jimg.read_image(tmp_path / "v.npz").affine)
    assert isinstance(timg.get_io("NiftiIO"), timg.NiftiIO)
    timg.register_io("Mine", timg.NpyIO())
    assert isinstance(timg.get_io("Mine"), timg.NpyIO)


# ------------------------------------------------------------------- frames


def _j2k_plain(frame):
    from boa_tpu_torch.io import j2k

    return (j2k.decode(frame).astype(np.int64) & 0xFFFF).astype(np.uint16)


# codec -> (port's encoder, reference's encoder, library decode, reference's
# decode, plain version) of a 64x64 16-bit frame
CODECS = {
    "rle": (tc.encode_rle, jc.encode_rle, lambda f: tc.decode_rle(f, 64, 64, 2),
            lambda f: jc.decode_rle(f, 64, 64, 2), lambda f: tc._decode_rle_python(f, 64, 64, 2)),
    "jpegll": (tc.encode_jpeg_lossless_sv1, jc.encode_jpeg_lossless_sv1,
               tc.decode_jpeg_lossless, jc.decode_jpeg_lossless, tc._decode_jpegll_python),
    "jpegls": (tc.encode_jpeg_ls, jc.encode_jpeg_ls, tc.decode_jpeg_ls, jc.decode_jpeg_ls,
               tc._decode_jpegls_python),
    "j2k": (tc.encode_jpeg2000, jc.encode_jpeg2000, tc._decode_j2k_native,
            jc.decode_jpeg2000, _j2k_plain),
}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_frame_roundtrip_library_plain_and_reference(codec):
    """One CT-like frame: the port's encoder writes the reference's bytes,
    and the library's decode is bit-identical to the source, to the plain
    version and to the reference's decode of the same frame."""
    enc, ref_enc, dec, ref_dec, plain = CODECS[codec]
    img = _ct_slice(np.random.default_rng(3)).view(np.uint16)
    frame = enc(img)
    assert frame == ref_enc(img)
    got = dec(frame)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, plain(frame))
    np.testing.assert_array_equal(got, ref_dec(frame))


def test_decode_jpeg2000_prefers_the_library(monkeypatch):
    """decode_jpeg2000 goes to the library; only a stream the library
    rejects reaches Pillow, as in the reference."""
    img = _ct_slice(np.random.default_rng(4)).view(np.uint16)
    frame = tc.encode_jpeg2000(img)
    monkeypatch.setattr(tc, "_pil_jpeg2000", lambda: pytest.fail("Pillow was asked"))
    np.testing.assert_array_equal(tc.decode_jpeg2000(frame), img)
    monkeypatch.undo()
    asked = []
    real = tc._pil_jpeg2000
    monkeypatch.setattr(tc, "_pil_jpeg2000", lambda: asked.append(1) or real())

    def rejected(frame):
        raise ValueError("native J2K decode failed (rc=-1)")

    monkeypatch.setattr(tc, "_decode_j2k_native", rejected)
    np.testing.assert_array_equal(tc.decode_jpeg2000(frame), img)
    assert asked == [1]


def test_jpeg_ls_roundtrip_frames():
    """tests/test_dicom.py's JPEG-LS patterns (regular mode, run mode with
    end-of-line runs, the Golomb escape, 16-bit range): the library, the
    plain version and the reference's decode agree with the source."""
    rng = np.random.default_rng(5)
    cases = [
        _ct_slice(rng).view(np.uint16),
        np.full((40, 50), 1234, np.uint16),
        rng.integers(0, 65536, (20, 21)).astype(np.uint16),
        np.repeat(rng.integers(0, 16, (16, 8)), 8, axis=1).astype(np.uint16),
        (np.arange(48)[:, None] * 7 + np.arange(40)[None, :] * 3).astype(np.uint16),
    ]
    for img in cases:
        frame = tc.encode_jpeg_ls(img)
        assert frame == jc.encode_jpeg_ls(img)
        np.testing.assert_array_equal(tc._decode_jpegls_python(frame), img)
        np.testing.assert_array_equal(tc.decode_jpeg_ls(frame), img)
        np.testing.assert_array_equal(jc.decode_jpeg_ls(frame), img)


def test_jpeg2000_roundtrip_frames():
    rng = np.random.default_rng(6)
    cases = [_ct_slice(rng).view(np.uint16), np.full((40, 50), 1234, np.uint16),
             rng.integers(0, 65536, (20, 21)).astype(np.uint16)]
    for img in cases:
        frame = tc.encode_jpeg2000(img)
        assert frame[:2] == b"\xff\x4f"  # raw codestream, not JP2
        np.testing.assert_array_equal(tc.decode_jpeg2000(frame), img)
        np.testing.assert_array_equal(_j2k_plain(frame), img)


@pytest.mark.parametrize("ts_name", ["rle", "jpegll", "jpegls", "j2k"])
def test_compressed_file_read_parity(tmp_path, ts_name):
    """A compressed Part-10 file reads back identical to the uncompressed
    slice in both packages; stop_before_pixels still works."""
    img = _ct_slice(np.random.default_rng(7))
    raw16 = img.view(np.uint16)
    ds = td.Dataset()
    ds.SOPClassUID = td.CT_IMAGE_STORAGE
    ds.SOPInstanceUID = td.generate_uid(entropy_srcs=[ts_name])
    ds.Rows, ds.Columns = img.shape
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 1
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ts, frame = {"rle": (td.RLE_LOSSLESS, tc.encode_rle),
                 "jpegls": (td.JPEG_LS_LOSSLESS, tc.encode_jpeg_ls),
                 "j2k": (td.JPEG_2000_LOSSLESS, tc.encode_jpeg2000),
                 "jpegll": (td.JPEG_LOSSLESS_SV1, tc.encode_jpeg_lossless_sv1)}[ts_name]
    ds.PixelData = td.encapsulate([frame(raw16)])
    meta = td.Dataset()
    meta.TransferSyntaxUID = ts
    ds.file_meta = meta
    p = tmp_path / f"{ts_name}.dcm"
    td.dcmwrite(p, ds)

    back = td.dcmread(p)
    assert back.file_meta.get("TransferSyntaxUID") == ts
    arr = td.pixel_array(back)
    assert arr.dtype == np.int16
    np.testing.assert_array_equal(arr, img)
    np.testing.assert_array_equal(jd.pixel_array(jd.dcmread(p)), img)
    hdr = td.dcmread(p, stop_before_pixels=True)
    assert hdr.get("PixelData") is None
    assert int(hdr.get("Rows")) == img.shape[0]


def test_multiframe_jpegll_with_offset_table(tmp_path):
    rng = np.random.default_rng(8)
    frames_np = [_ct_slice(rng).view(np.uint16) for _ in range(3)]
    frames = [tc.encode_jpeg_lossless_sv1(f) for f in frames_np]
    enc = td.encapsulate(frames)
    assert enc.fragments == jd.encapsulate(frames).fragments
    ds = td.Dataset()
    ds.SOPClassUID = td.CT_IMAGE_STORAGE
    ds.SOPInstanceUID = td.generate_uid(entropy_srcs=["mf"])
    ds.Rows, ds.Columns = frames_np[0].shape
    ds.BitsAllocated = 16
    ds.PixelRepresentation = 0
    ds.NumberOfFrames = 3
    ds.PixelData = enc
    meta = td.Dataset()
    meta.TransferSyntaxUID = td.JPEG_LOSSLESS_SV1
    ds.file_meta = meta
    p = tmp_path / "mf.dcm"
    td.dcmwrite(p, ds)
    arr = td.pixel_array(td.dcmread(p))
    assert arr.shape == (3, *frames_np[0].shape)
    for k in range(3):
        np.testing.assert_array_equal(arr[k], frames_np[k])
    np.testing.assert_array_equal(jd.pixel_array(jd.dcmread(p)), arr)


def test_unsupported_syntax_clear_error(tmp_path):
    ds = td.Dataset()
    ds.SOPClassUID = td.CT_IMAGE_STORAGE
    ds.SOPInstanceUID = td.generate_uid(entropy_srcs=["be"])
    meta = td.Dataset()
    meta.TransferSyntaxUID = td.EXPLICIT_VR_BE  # big endian: unsupported
    ds.file_meta = meta
    p = tmp_path / "bad.dcm"
    td.dcmwrite(p, ds)
    raw = bytearray(p.read_bytes())
    idx = raw.find(b"1.2.840.10008.1.2.1\x00")
    if idx >= 0:
        raw[idx:idx + 20] = b"1.2.840.10008.1.2.2"[:20].ljust(20, b"\x00")
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="transfer syntax") as got:
        td.dcmread(p)
    with pytest.raises(ValueError) as want:
        jd.dcmread(p)
    assert str(got.value) == str(want.value)


def _dct_oracle(img, precision, qt):
    shift = 1 << (precision - 1)
    rows, cols = img.shape
    ph, pw = -(-rows // 8) * 8, -(-cols // 8) * 8
    padded = np.pad(img.astype(np.float64) - shift, ((0, ph - rows), (0, pw - cols)),
                    mode="edge")
    b = tc._jdct_basis()
    blocks = padded.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
    f = np.einsum("ux,ijxy,vy->ijuv", b, blocks, b)
    q = np.round(f / qt.reshape(8, 8)) * qt.reshape(8, 8)
    sp = np.einsum("ux,ijuv,vy->ijxy", b, q, b)
    rec = np.clip(np.round(sp) + shift, 0, (1 << precision) - 1)
    return rec.transpose(0, 2, 1, 3).reshape(ph, pw)[:rows, :cols].astype(np.uint16)


def test_jpeg_dct_decode_matches_quantized_reconstruction():
    """Lossy JPEG, baseline 8-bit and extended 12-bit: the library gives
    round(IDCT(dequantized coefficients)) exactly, the reference's decode
    of the same stream, and with a unit table the source within ±1."""
    rng = np.random.default_rng(7)
    qt1 = np.ones(64, np.int64)
    x = np.linspace(0, 255, 37)[None, :] * np.ones((29, 1))
    img8 = (x + rng.normal(0, 10, (29, 37))).clip(0, 255).astype(np.uint16)
    img12 = rng.normal(2048, 400, (45, 52)).clip(0, 4095).astype(np.uint16)
    qtq = np.clip(tc._JDCT_STD_QT * 2, 1, 255)
    for img, precision, qt, tight in ((img8, 8, qt1, True), (img12, 12, qt1, True),
                                      (img8, 8, qtq, False)):
        frame = tc.encode_jpeg_dct(img, precision=precision, quant_table=qt)
        assert frame == jc.encode_jpeg_dct(img, precision=precision, quant_table=qt)
        dec = tc.decode_jpeg_dct(frame)
        np.testing.assert_array_equal(dec, _dct_oracle(img, precision, qt))
        np.testing.assert_array_equal(dec, jc.decode_jpeg_dct(frame))
        if tight:
            assert np.abs(dec.astype(int) - img.astype(int)).max() <= 1


def test_jpeg_dct_pil_cross_validation():
    """Pillow-encoded grayscale, 4:4:4 and 4:2:0 colour streams: the
    library's decode equals the reference's, and within ±1 (luma ±5) of
    libjpeg's."""
    import io

    from PIL import Image

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (40, 33)).astype(np.uint16)
    ours = tc.encode_jpeg_dct(img, precision=8, quant_table=np.ones(64, np.int64))
    pil = np.asarray(Image.open(io.BytesIO(ours)))
    assert np.abs(pil.astype(int) - tc.decode_jpeg_dct(ours).astype(int)).max() <= 1

    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8), "L").save(buf, "JPEG", quality=90)
    dec = tc.decode_jpeg_dct(buf.getvalue())
    ref = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
    assert dec.shape == img.shape
    assert np.abs(dec.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(dec, jc.decode_jpeg_dct(buf.getvalue()))

    rgb = rng.integers(0, 256, (24, 31, 3)).astype(np.uint8)
    smooth = np.clip(np.add.outer(np.linspace(0, 200, 26), np.linspace(0, 40, 34)), 0, 255)
    rgb2 = np.stack([smooth, smooth * 0.8, smooth * 0.5], -1).astype(np.uint8)
    for arr, sub in ((rgb, 0), (rgb2, 2)):
        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=95, subsampling=sub)
        dec3 = tc.decode_jpeg_dct(buf.getvalue())
        assert dec3.shape == arr.shape
        ycc = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("YCbCr"))
        assert np.abs(dec3[..., 0].astype(int) - ycc[..., 0].astype(int)).max() <= 5
        np.testing.assert_array_equal(dec3, jc.decode_jpeg_dct(buf.getvalue()))


def test_jpeg_extended_ct_series_roundtrip(tmp_path):
    """A CT series as JPEG Extended 12-bit (…4.51) reads back with small
    lossy error and the HU rescale (unsigned 12-bit, intercept -1024), the
    same volume in both packages."""
    rng = np.random.default_rng(7)
    smooth = np.add.outer(np.linspace(-500, 500, 24), np.linspace(0, 200, 20))
    data = np.repeat(smooth[:, :, None], 6, axis=2).astype(np.int16)
    data += rng.integers(-5, 5, data.shape).astype(np.int16)
    img = tn.NiftiImage(data=data, affine=np.diag([1.0, 1.0, 3.0, 1.0]))
    files = tio.write_ct_series(img, tmp_path / "dcm", transfer_syntax=td.JPEG_EXTENDED)
    ds = td.dcmread(files[0])
    assert ds.BitsStored == 12 and ds.LossyImageCompression == "01"
    back, _, _ = tio.read_series(tmp_path / "dcm")
    err = np.abs(back.data.astype(int) - data.astype(int))
    assert err.mean() < 8 and err.max() < 80
    assert back.shape == img.shape
    np.testing.assert_array_equal(back.data, jio.read_series(tmp_path / "dcm")[0].data)


def _patch_sos_pt(frame: bytes, pt: int) -> bytes:
    """Set the point transform (SOS Al nibble) of a single-scan stream."""
    pos = 2
    buf = bytearray(frame)
    while pos < len(buf):
        marker = buf[pos + 1]
        pos += 2
        if marker == 0xD8:
            continue
        seg = int.from_bytes(buf[pos:pos + 2], "big")
        if marker == 0xDA:
            ns = buf[pos + 2]
            al_at = pos + 2 + 1 + 2 * ns + 2
            buf[al_at] = (buf[al_at] & 0xF0) | pt
            return bytes(buf)
        pos += seg
    raise AssertionError("no SOS")


def test_jpegll_point_transform_plain_matches_library():
    """Pt > 0: the plain version, the library and the reference's library
    agree (prediction in the unshifted domain, T.81 H.2.1)."""
    img = np.random.default_rng(9).integers(0, 1 << 12, (23, 17)).astype(np.uint16)
    frame = _patch_sos_pt(tc.encode_jpeg_lossless_sv1(img, precision=12), pt=1)
    got_py = tc._decode_jpegll_python(frame)
    assert got_py.dtype == np.uint16 and got_py.shape == img.shape
    got = tc._decode_jpegll_native(tnative.lib("jpegll"), frame)
    np.testing.assert_array_equal(got_py, got)
    np.testing.assert_array_equal(got, tc.decode_jpeg_lossless(frame))
    if jnative.get_lib() is not None:
        np.testing.assert_array_equal(got, jc._decode_jpegll_native(jnative.get_lib(), frame))


def test_jpegll_plain_rejects_restart_intervals():
    img = np.random.default_rng(10).integers(0, 256, (8, 8)).astype(np.uint16)
    frame = tc.encode_jpeg_lossless_sv1(img, precision=8)
    dri = bytes([0xFF, 0xDD, 0x00, 0x04, 0x00, 0x08])
    with pytest.raises(ValueError, match="restart"):
        tc._decode_jpegll_python(frame[:2] + dri + frame[2:])


def test_un_undefined_length_sequence_implicit_content(tmp_path):
    """PS3.5 6.2.2: undefined-length UN contents are implicit VR LE even in
    an explicit-VR file; both packages parse the same item."""
    ds = td.Dataset()
    ds.PatientName = "UN^Seq"
    buf = bytearray()
    buf += struct.pack("<HH", 0x0009, 0x0010) + b"UN\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
    buf += struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF)
    payload = b"PRIVATE!"
    buf += struct.pack("<HHI", 0x0009, 0x0001, len(payload)) + payload
    buf += struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
    buf += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    path = tmp_path / "un.dcm"
    td.dcmwrite(path, ds)
    raw = bytes(bytearray(path.read_bytes()) + buf)
    for mod in (td, jd):
        back = mod.dcmread(raw)
        assert back.get("PatientName") == "UN^Seq"
        items = back.get((0x0009, 0x0010))
        assert isinstance(items, list) and len(items) == 1
        assert items[0].get((0x0009, 0x0001)) == payload


# ------------------------------------------------------------ host library


def test_sources_are_byte_copies():
    """The port builds its own copies of the reference's four decoders."""
    for stem in tnative.SOURCES:
        assert (ROOT / "boa_tpu_torch" / "native" / f"{stem}.cpp").read_bytes() == \
            (ROOT / "native" / f"{stem}.cpp").read_bytes(), stem


def test_failed_build_raises(tmp_path, monkeypatch):
    """No compiler, or a compiler that fails: the build raises with its
    output and the decode path raises with it (no quiet plain version)."""
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    with monkeypatch.context() as m:
        m.setattr(tnative.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="g[+][+] not found"):
            tnative.build_all()
    monkeypatch.setattr(tnative, "CXX_FLAGS", (*tnative.CXX_FLAGS, "-include", "no_such_header.h"))
    frame = tc.encode_jpeg_ls(np.arange(64, dtype=np.uint16).reshape(8, 8))
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed for .*no_such_header"):
        tc.decode_jpeg_ls(frame)
    assert not list((tmp_path / "build").rglob("*.so"))


_BUILD = r"""
import sys
from pathlib import Path
from boa_tpu_torch import native
native.BUILD_ROOT = Path(sys.argv[1])
native.build_all()
print(native.build_info["dir"])
"""


def test_concurrent_builds(tmp_path):
    """Three processes building into one empty cache at once all load the
    same four libraries; a fourth finds them built."""
    cmd = [sys.executable, "-c", _BUILD, str(tmp_path / "cache")]
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    dirs = {o[0].strip() for o in outs}
    assert len(dirs) == 1
    built = Path(dirs.pop())
    assert sorted(p.name for p in built.iterdir()) == sorted(
        f"lib{s}.so" for s in tnative.SOURCES)


def test_decoder_timing_holds_library_to_plain():
    """`python -m boa_tpu_torch.native.timing`'s work on a small slice of
    the bench anatomy: every lossless codec equal to the source and to its
    plain version, the lossy one close."""
    from boa_tpu_torch.native import timing

    sl = timing.bench_slice(160)
    assert sl.shape == (160, 160) and sl.dtype == np.int16
    got = timing.time_decoders(sl, reps=1)
    assert list(got["codecs"]) == ["rle", "jpeg_lossless_sv1", "jpeg_ls", "jpeg_2000",
                                   "jpeg_extended_12bit"]
    for name, row in got["codecs"].items():
        assert row["library_ms"] > 0, name
        if name != "jpeg_extended_12bit":
            assert row["library_equal_source"] and row["plain_equal_library"], name
