"""The port's NIfTI file codec (boa_tpu_torch/io/nifti.py) against the
reference's (boa_tpu/io/nifti.py), same arrays made with numpy from a seed.

Bars: a file either package writes is byte-identical to the other's and
loads bit-identically in both (data, dtype, affine, extensions, descrip);
headers, the scl slope/inter, qform-only and sform files, and the body-crop
pad-back on save agree exactly, from any memory order of the volume; the
writer's layout pass counts the bytes it lays out under a profiler.
"""

import struct

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from boa_tpu.io import nifti as jn
from boa_tpu.ops import cropping as jcrop
from boa_tpu_torch.io import nifti as tn
from boa_tpu_torch.ops import cropping as tcrop
from boa_tpu_torch.utils import timing

AFFINES = {
    "axial_lps": np.array([[-0.7, 0, 0, 120], [0, -0.7, 0, 95], [0, 0, 2.5, -400],
                           [0, 0, 0, 1.0]]),
    "oblique_permuted": np.array([[0.1, 0, 1.98, -50], [-0.99, 0.05, 0, 30],
                                  [0, 1.2, 0.1, -20], [0, 0, 0, 1.0]]),
}


def _data(dtype, shape=(17, 19, 23), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int16:
        return rng.integers(-1024, 3071, size=shape).astype(np.int16)
    if dtype == np.uint8:
        return rng.integers(0, 118, size=shape).astype(np.uint8)
    return (rng.normal(size=shape) * 100).astype(np.float32)


def _same_image(a, b):
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    assert np.asarray(a.data).dtype == np.asarray(b.data).dtype
    np.testing.assert_array_equal(a.affine, b.affine)
    assert a.extensions == b.extensions
    assert a.descrip == b.descrip


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("affine", sorted(AFFINES))
def test_files_identical_across_packages(tmp_path, dtype, suffix, affine):
    data = _data(dtype)
    aff = AFFINES[affine]
    timg = tn.NiftiImage(data=data, affine=aff.copy())
    jimg = jn.NiftiImage(data=data, affine=aff.copy())
    if dtype == np.uint8:
        names = {i: f"class_{i}" for i in range(1, 118)}
        timg.set_label_map(names)
        jimg.set_label_map(names)
    # one file name in two folders: gzip stores the name in its header
    paths = {k: tmp_path / k / f"x{suffix}" for k in ("t", "j")}
    for p in paths.values():
        p.parent.mkdir()
    tn.save(timg, paths["t"])
    jn.save(jimg, paths["j"])
    assert paths["t"].read_bytes() == paths["j"].read_bytes()
    for p in paths.values():
        got, want = tn.load(p), jn.load(p)
        _same_image(got, want)
        np.testing.assert_array_equal(got.data, data)
        shape, aff_h = tn.load_header(p)
        assert shape == data.shape
        np.testing.assert_array_equal(aff_h, jn.load_header(p)[1])
    if dtype == np.uint8:
        assert tn.load(paths["j"]).get_label_map() == names


def _rewrite(path, fields):
    """Patch header fields (struct format, offset, values) of a .nii file."""
    raw = bytearray(path.read_bytes())
    for fmt, off, vals in fields:
        struct.pack_into(fmt, raw, off, *vals)
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("case", ["slope_inter", "slope_nan", "slope_zero", "inter_nan",
                                  "qform_only", "no_form", "big_endian", "dtype_arg"])
def test_header_variants_load_identically(tmp_path, case):
    data = _data(np.int16, (6, 7, 8), seed=1)
    p = tmp_path / "x.nii"
    tn.save(tn.NiftiImage(data=data, affine=AFFINES["oblique_permuted"].copy()), p)
    kw = {}
    if case == "slope_inter":
        _rewrite(p, [("<2f", 112, (2.0, 10.0))])
    elif case == "slope_nan":
        _rewrite(p, [("<2f", 112, (float("nan"), 10.0))])
    elif case == "slope_zero":
        _rewrite(p, [("<2f", 112, (0.0, 10.0))])
    elif case == "inter_nan":
        _rewrite(p, [("<2f", 112, (0.5, float("nan")))])
    elif case == "qform_only":   # sform_code 0: the quaternion affine
        _rewrite(p, [("<2h", 252, (1, 0))])
    elif case == "no_form":      # neither: pixdim on the diagonal
        _rewrite(p, [("<2h", 252, (0, 0))])
    elif case == "big_endian":
        raw = p.read_bytes()
        h = jn._parse_header(raw)
        out = bytearray(raw)
        for fmt, off in (("i", 0), ("8h", 40), ("2h", 70), ("8f", 76), ("f", 108),
                         ("2f", 112), ("2h", 252), ("6f", 256), ("4f", 280), ("4f", 296),
                         ("4f", 312)):
            struct.pack_into(">" + fmt, out, off, *struct.unpack_from("<" + fmt, raw, off))
        vox = int(h["vox_offset"])
        out[vox:] = data.astype(">i2").tobytes(order="F")
        p.write_bytes(bytes(out))
    else:
        kw = {"dtype": np.float32}
    got, want = tn.load(p, **kw), jn.load(p, **kw)
    _same_image(got, want)
    np.testing.assert_array_equal(tn.load_header(p)[1], jn.load_header(p)[1])
    if case == "slope_inter":
        np.testing.assert_array_equal(got.data, data.astype(np.float32) * 2 + 10)
    if case in ("slope_nan", "slope_zero", "big_endian"):
        np.testing.assert_array_equal(got.data, data)
    if case == "qform_only":
        np.testing.assert_allclose(got.affine, tn.load(tmp_path / "x.nii").affine)


def test_quaternion_helpers_match_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        assert tn._rotation_to_quaternion(q) == jn._rotation_to_quaternion(q)
        b, c, d = tn._rotation_to_quaternion(q)
        np.testing.assert_array_equal(tn._quaternion_to_rotation(b, c, d),
                                      jn._quaternion_to_rotation(b, c, d))
        np.testing.assert_allclose(tn._quaternion_to_rotation(b, c, d), q, atol=1e-12)


@pytest.mark.parametrize("ndim", [3, 4])
def test_body_crop_pads_back_on_save(tmp_path, ndim):
    """A body-cropped label image is written on the original grid."""
    shape = (256, 240, 6)
    ct = np.full(shape, -1000, np.int16)
    ct[60:120, 50:110] = 40
    aff = AFFINES["axial_lps"]
    tcut, tinfo = tcrop.body_crop_xy(tn.NiftiImage(data=ct, affine=aff.copy()))
    jcut, jinfo = jcrop.body_crop_xy(jn.NiftiImage(data=ct, affine=aff.copy()))
    assert tinfo is not None and (tinfo.x0, tinfo.x1, tinfo.y0, tinfo.y1) == \
        (jinfo.x0, jinfo.x1, jinfo.y0, jinfo.y1)
    labels = _data(np.uint8, tcut.shape + ((2,) if ndim == 4 else ()), seed=2)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tn.save(tn.NiftiImage(data=labels, affine=tcut.affine, crop_info=tinfo),
            tmp_path / "t" / "x.nii.gz")
    jn.save(jn.NiftiImage(data=labels, affine=jcut.affine, crop_info=jinfo),
            tmp_path / "j" / "x.nii.gz")
    assert (tmp_path / "t" / "x.nii.gz").read_bytes() == \
        (tmp_path / "j" / "x.nii.gz").read_bytes()
    back = tn.load(tmp_path / "t" / "x.nii.gz")
    assert back.shape[:3] == shape
    np.testing.assert_array_equal(back.affine, jn.load(tmp_path / "t" / "x.nii.gz").affine)
    np.testing.assert_allclose(back.affine, aff, atol=1e-5)  # float32 in the header
    np.testing.assert_array_equal(back.data, tcrop.pad_back(labels, tinfo))


def test_empty_like_matches_reference():
    aff = AFFINES["axial_lps"]
    got, want = tn.empty_like((3, 4, 5), aff), jn.empty_like((3, 4, 5), aff)
    _same_image(got, want)
    assert got.affine is not aff


def _ordered(dtype, shape, order):
    """A volume of `shape` in the memory order `order`: C, F, reversed (a
    [::-1] view of a C array) or transposed (a C array's x and y swapped)."""
    if order == "transposed":
        return _data(dtype, (shape[1], shape[0], shape[2]), seed=5).transpose(1, 0, 2)
    data = _data(dtype, shape, seed=5)
    if order == "F":
        return np.asfortranarray(data)
    return data[::-1] if order == "reversed" else data


def _crops(shape, aff):
    """The same in-plane crop of `shape` as each package's BodyCrop: the
    volume sits at (2, 3) in a grid 5 wider in x and 4 in y."""
    nx, ny, nz = shape
    grid = (nx + 5, ny + 4, nz)
    return tuple(mod.BodyCrop(orig_shape=grid, orig_affine=aff.copy(), x0=2, x1=2 + nx,
                              y0=3, y1=3 + ny) for mod in (tcrop, jcrop))


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 7), (130, 70, 33), (64, 64, 64)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("cropped", [False, True])
@pytest.mark.parametrize("order", ["C", "F", "reversed", "transposed"])
def test_layouts_write_reference_bytes(tmp_path, monkeypatch, order, cropped, dtype,
                                       shape, suffix):
    """A 3-D volume in any memory order, cropped or not, gives the
    reference's file: slabs of 4 slices, so a volume spans several and the
    last may be short."""
    data = _ordered(dtype, shape, order)
    assert data.flags.f_contiguous == (order == "F" or shape == (1, 1, 1))
    aff = AFFINES["oblique_permuted"]
    tinfo, jinfo = _crops(shape, aff) if cropped else (None, None)
    grid = tinfo.orig_shape if cropped else shape
    monkeypatch.setattr(tn, "_SLAB_BYTES", 4 * grid[0] * grid[1] * data.itemsize)
    paths = {k: tmp_path / k / f"x{suffix}" for k in ("t", "j")}
    for p in paths.values():
        p.parent.mkdir()
    tn.save(tn.NiftiImage(data=data, affine=aff.copy(), crop_info=tinfo), paths["t"])
    jn.save(jn.NiftiImage(data=data, affine=aff.copy(), crop_info=jinfo), paths["j"])
    assert paths["t"].read_bytes() == paths["j"].read_bytes()
    want = tcrop.pad_back(data, tinfo) if cropped else data
    np.testing.assert_array_equal(tn.load(paths["t"]).data, want)


@pytest.mark.parametrize("case", ["c_cropped", "fortran", "4d"])
def test_layout_bytes_counted(tmp_path, fresh_recorder, case):
    """`nifti_layout_bytes`: the padded voxel bytes of a C-ordered cropped
    3-D save, 0 where the volume is Fortran-ordered or not 3-D."""
    shape = (70, 66, 9)
    aff = AFFINES["axial_lps"]
    data = _data(np.int16, shape + ((2,) if case == "4d" else ()), seed=6)
    if case == "fortran":
        data = np.asfortranarray(data)
    crop = _crops(shape, aff)[0]
    with profile(activities=[ProfilerActivity.CPU]):
        tn.save(tn.NiftiImage(data=data, affine=aff.copy(), crop_info=crop),
                tmp_path / "x.nii.gz")
    tr = timing.last_trace()
    want = 75 * 70 * 9 * 2 if case == "c_cropped" else 0
    assert tr.total("nifti_layout_bytes") == want
    assert tr.total("save_bytes") == 75 * 70 * 9 * 2 * (2 if case == "4d" else 1)


@pytest.fixture()
def fresh_recorder(monkeypatch):
    """The profiler's recorder as at the process's start."""
    monkeypatch.setattr(timing, "_capture", None)
    monkeypatch.setattr(timing, "_taking", False)
