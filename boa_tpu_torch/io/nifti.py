"""NIfTI-1 reader/writer, image record and orientation math.

Counterpart of `boa_tpu/io/nifti.py`: the file codec (348-byte header,
qform/sform affines, scl slope/inter, the gzip container and the label-map
JSON extension TotalSegmentator attaches), the in-memory `NiftiImage` (data
indexed [x, y, z], Fortran order on disk, affine mapping voxel indices to
RAS+ mm), nibabel-style orientation on the host and the same reorientation
as tensor flips/permutes on the device. Files written here are
byte-identical to the reference's.
"""

from __future__ import annotations

import gzip
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from boa_tpu_torch.utils import timing

# NIfTI-1 datatype codes <-> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


def _quaternion_to_rotation(b: float, c: float, d: float) -> np.ndarray:
    """qform quaternion (b,c,d with a = sqrt(1-b2-c2-d2)) -> 3x3 rotation."""
    w2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(w2) if w2 > 0 else 0.0
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )


def _rotation_to_quaternion(rot: np.ndarray) -> tuple[float, float, float]:
    """3x3 rotation matrix -> (b, c, d) quaternion components, a >= 0."""
    m = rot
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        a = 0.25 / s
        b = (m[2, 1] - m[1, 2]) * s
        c = (m[0, 2] - m[2, 0]) * s
        d = (m[1, 0] - m[0, 1]) * s
    else:
        # the dominant diagonal term picks the stable formula
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        if i == 0:
            s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
            a = (m[2, 1] - m[1, 2]) / s
            b = 0.25 * s
            c = (m[0, 1] + m[1, 0]) / s
            d = (m[0, 2] + m[2, 0]) / s
        elif i == 1:
            s = 2.0 * np.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2])
            a = (m[0, 2] - m[2, 0]) / s
            b = (m[0, 1] + m[1, 0]) / s
            c = 0.25 * s
            d = (m[1, 2] + m[2, 1]) / s
        else:
            s = 2.0 * np.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2])
            a = (m[1, 0] - m[0, 1]) / s
            b = (m[0, 2] + m[2, 0]) / s
            c = (m[1, 2] + m[2, 1]) / s
            d = 0.25 * s
    if a < 0:
        a, b, c, d = -a, -b, -c, -d
    return float(b), float(c), float(d)


@dataclass
class NiftiImage:
    """In-memory NIfTI image: data array + RAS affine + optional extras."""

    data: np.ndarray
    affine: np.ndarray
    # scl_slope/scl_inter are applied by load()
    extensions: list[tuple[int, bytes]] = field(default_factory=list)
    descrip: bytes = b"boa_tpu"
    # set when this image lives on a body-cropped grid (ops/cropping.BodyCrop):
    # save() zero-pads back to the original grid
    crop_info: object | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def zooms(self) -> tuple[float, ...]:
        return tuple(float(np.linalg.norm(self.affine[:3, i])) for i in range(3))

    def device_data(self, device: torch.device) -> torch.Tensor:
        """The voxel array on `device`, uploaded at most once per image.

        The cache is keyed on the identity of `data`: replace `img.data`
        rather than mutating it in place."""
        cached = getattr(self, "_device_data", None)
        if cached is None or cached[0] is not self.data or cached[1] != device:
            from boa_tpu_torch.ops import packing

            cached = (self.data, device, packing.upload_ct(self.data, device))
            object.__setattr__(self, "_device_data", cached)
        return cached[2]

    def set_label_map(self, label_map: dict[int, str]) -> None:
        payload = json.dumps({str(k): v for k, v in label_map.items()}).encode()
        self.extensions = [e for e in self.extensions if e[0] != 44]
        self.extensions.append((44, payload))

    def get_label_map(self) -> dict[int, str] | None:
        for ecode, payload in self.extensions:
            if ecode == 44:
                try:
                    raw = json.loads(payload.decode().rstrip("\x00"))
                    return {int(k): v for k, v in raw.items()}
                except (ValueError, UnicodeDecodeError):
                    return None
        return None


def _build_affine_from_header(h: dict) -> np.ndarray:
    if h["sform_code"] > 0:
        aff = np.eye(4)
        aff[0, :] = h["srow_x"]
        aff[1, :] = h["srow_y"]
        aff[2, :] = h["srow_z"]
        return aff
    if h["qform_code"] > 0:
        rot = _quaternion_to_rotation(h["quatern_b"], h["quatern_c"], h["quatern_d"])
        qfac = -1.0 if h["pixdim"][0] < 0 else 1.0
        zooms = np.array(h["pixdim"][1:4])
        zooms[2] *= qfac
        aff = np.eye(4)
        aff[:3, :3] = rot * zooms[None, :]
        aff[:3, 3] = [h["qoffset_x"], h["qoffset_y"], h["qoffset_z"]]
        return aff
    return np.diag([h["pixdim"][1], h["pixdim"][2], h["pixdim"][3], 1.0])


def _parse_header(buf: bytes) -> dict:
    if len(buf) < _HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    (sizeof_hdr,) = struct.unpack_from("<i", buf, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", buf, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("not a NIfTI-1 file")
        endian = ">"
    h: dict = {"endian": endian}
    h["dim"] = struct.unpack_from(endian + "8h", buf, 40)
    h["datatype"], h["bitpix"] = struct.unpack_from(endian + "2h", buf, 70)
    h["pixdim"] = struct.unpack_from(endian + "8f", buf, 76)
    (h["vox_offset"],) = struct.unpack_from(endian + "f", buf, 108)
    h["scl_slope"], h["scl_inter"] = struct.unpack_from(endian + "2f", buf, 112)
    h["descrip"] = struct.unpack_from("80s", buf, 148)[0]
    h["qform_code"], h["sform_code"] = struct.unpack_from(endian + "2h", buf, 252)
    (h["quatern_b"], h["quatern_c"], h["quatern_d"],
     h["qoffset_x"], h["qoffset_y"], h["qoffset_z"]) = struct.unpack_from(
        endian + "6f", buf, 256)
    h["srow_x"] = struct.unpack_from(endian + "4f", buf, 280)
    h["srow_y"] = struct.unpack_from(endian + "4f", buf, 296)
    h["srow_z"] = struct.unpack_from(endian + "4f", buf, 312)
    h["magic"] = struct.unpack_from("4s", buf, 344)[0]
    return h


def _read_bytes(path: str | Path) -> bytes:
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def load_header(path: str | Path) -> tuple[tuple[int, ...], np.ndarray]:
    """(shape, affine) from the header alone: only the head of a .nii.gz
    stream is decompressed."""
    path = Path(path)
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read(4096)
    h = _parse_header(raw)
    shape = tuple(int(d) for d in h["dim"][1:1 + h["dim"][0]])
    return shape, _build_affine_from_header(h)


def load(path: str | Path, *, dtype: np.dtype | None = None) -> NiftiImage:
    """Load a .nii or .nii.gz file. Applies scl_slope/scl_inter if non-trivial."""
    raw = _read_bytes(path)
    h = _parse_header(raw)
    shape = tuple(int(d) for d in h["dim"][1:1 + h["dim"][0]])
    np_dtype = _DTYPES.get(h["datatype"])
    if np_dtype is None:
        raise ValueError(f"unsupported NIfTI datatype code {h['datatype']}")
    vox_offset = int(h["vox_offset"]) if h["vox_offset"] >= _HDR_SIZE else _HDR_SIZE + 4

    # extensions: 4 flag bytes after the header, then esize/ecode blocks
    extensions: list[tuple[int, bytes]] = []
    if len(raw) > _HDR_SIZE + 4 and raw[_HDR_SIZE] != 0:
        off = _HDR_SIZE + 4
        while off + 8 <= vox_offset:
            esize, ecode = struct.unpack_from(h["endian"] + "2i", raw, off)
            if esize <= 0:
                break
            extensions.append((ecode, raw[off + 8:off + esize]))
            off += esize

    count = int(np.prod(shape)) if shape else 0
    arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder(h["endian"]),
                        count=count, offset=vox_offset)
    arr = arr.reshape(shape, order="F")
    if h["endian"] == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    slope, inter = float(h["scl_slope"]), float(h["scl_inter"])
    # nibabel's semantics: a slope of 0 or NaN means no scaling (inter is
    # then ignored), and a NaN inter is ignored
    if slope == 0.0 or np.isnan(slope):
        slope, inter = 1.0, 0.0
    if np.isnan(inter):
        inter = 0.0
    if slope != 1.0 or inter != 0.0:
        arr = arr.astype(np.float32) * np.float32(slope) + np.float32(inter)
    arr = arr.astype(dtype) if dtype is not None else np.asarray(arr)
    return NiftiImage(data=arr, affine=_build_affine_from_header(h),
                      extensions=extensions, descrip=h["descrip"])


def save(img: NiftiImage, path: str | Path) -> None:
    """Write a .nii or .nii.gz (by extension) with sform and qform set from
    the affine. A body-cropped image (`crop_info`) is zero-padded back to
    its original grid. Counts `save_bytes` (the voxel bytes after the
    pad-back) and `save_gz_bytes` (the file's bytes) while a profiler
    records (`utils/timing.py`)."""
    path = Path(path)
    data = np.asanyarray(img.data)
    crop = img.crop_info
    if crop is not None:
        img = NiftiImage(data=data, affine=crop.orig_affine,
                         extensions=img.extensions, descrip=img.descrip)
        if data.ndim != 3:  # 3-D volumes pad slice by slice in the writer below
            from boa_tpu_torch.ops.cropping import pad_back

            data, crop = pad_back(data, crop), None
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    dt_code = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8
    ndim = data.ndim
    out_shape = list(data.shape)
    if crop is not None:
        out_shape[:2] = list(crop.orig_shape[:2])
    dim = [ndim] + out_shape + [1] * (7 - ndim)

    aff = np.asarray(img.affine, dtype=np.float64)
    zooms = [float(np.linalg.norm(aff[:3, i])) for i in range(min(3, ndim))]
    zooms += [1.0] * (7 - len(zooms))

    # qform from the affine: R = A[:3, :3] / zooms, qfac from the determinant,
    # stored as the nearest rotation
    rot = aff[:3, :3] / np.array([z if z > 0 else 1.0 for z in zooms[:3]])[None, :]
    qfac = 1.0
    if np.linalg.det(rot) < 0:
        rot = rot.copy()
        rot[:, 2] *= -1
        qfac = -1.0
    u, _, vt = np.linalg.svd(rot)
    qb, qc, qd = _rotation_to_quaternion(u @ vt)

    ext_blocks = b""
    for ecode, payload in img.extensions:
        esize = 8 + len(payload)
        pad = (16 - esize % 16) % 16
        esize += pad
        ext_blocks += struct.pack("<2i", esize, ecode) + payload + b"\x00" * pad
    vox_offset = _HDR_SIZE + 4 + len(ext_blocks)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, dt_code, bitpix)
    struct.pack_into("<8f", hdr, 76, qfac, *zooms)
    struct.pack_into("<f", hdr, 108, float(vox_offset))
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    struct.pack_into("<80s", hdr, 148, img.descrip[:80])
    struct.pack_into("<2h", hdr, 252, 1, 1)  # qform_code, sform_code = SCANNER_ANAT
    struct.pack_into("<6f", hdr, 256, qb, qc, qd,
                     float(aff[0, 3]), float(aff[1, 3]), float(aff[2, 3]))
    struct.pack_into("<4f", hdr, 280, *aff[0, :])
    struct.pack_into("<4f", hdr, 296, *aff[1, :])
    struct.pack_into("<4f", hdr, 312, *aff[2, :])
    struct.pack_into("<4s", hdr, 344, b"n+1\x00")
    ext_flag = b"\x01\x00\x00\x00" if ext_blocks else b"\x00\x00\x00\x00"
    head = bytes(hdr) + ext_flag + ext_blocks

    # 3-D volumes go out one z-slice at a time: the pad-back, the
    # Fortran-order copy and the compression work in steps of one slice, so
    # a save on a HostWorker thread never holds the interpreter lock for
    # a whole volume
    def _write_body(f) -> None:
        f.write(head)
        if ndim != 3:
            f.write(data.tobytes(order="F"))
            return
        pad2d = None
        if crop is not None:
            pad2d = np.zeros(tuple(crop.orig_shape[:2]), dtype=data.dtype)
        for k in range(data.shape[2]):
            sl = data[:, :, k]
            if pad2d is not None:
                pad2d[crop.x0:crop.x1, crop.y0:crop.y1] = sl
                sl = pad2d
            f.write(sl.tobytes(order="F"))

    with open(path, "wb") as raw:
        if path.name.endswith(".gz"):
            # mtime 0: the same image gives the same bytes
            with gzip.GzipFile(fileobj=raw, mode="wb", compresslevel=1,
                               mtime=0) as f:
                _write_body(f)
        else:
            _write_body(raw)
        timing.count("save_bytes", int(np.prod(out_shape)) * data.dtype.itemsize)
        timing.count("save_gz_bytes", raw.tell())


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """For each input axis, (RAS output axis, +1/-1 direction)."""
    rzs = affine[:3, :3].copy()
    lengths = np.sqrt((rzs ** 2).sum(axis=0))
    lengths[lengths == 0] = 1
    rzs /= lengths[None, :]
    ornt = np.zeros((3, 2))
    mat = rzs.copy()
    for _ in range(3):
        out_ax, in_ax = np.unravel_index(np.argmax(np.abs(mat)), mat.shape)
        ornt[in_ax, 0] = out_ax
        ornt[in_ax, 1] = 1.0 if mat[out_ax, in_ax] > 0 else -1.0
        mat[out_ax, :] = 0
        mat[:, in_ax] = 0
    return ornt


def apply_orientation(data: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    """Flip and reorder the first 3 axes of `data` according to `ornt`."""
    out = data
    for ax in range(3):
        if ornt[ax, 1] < 0:
            out = np.flip(out, axis=ax)
    perm = np.argsort(ornt[:, 0]).tolist() + list(range(3, data.ndim))
    return np.transpose(out, perm)


def apply_orientation_device(data: torch.Tensor, ornt: np.ndarray) -> torch.Tensor:
    """`apply_orientation` as tensor ops on the tensor's device."""
    out = data
    flips = [ax for ax in range(3) if ornt[ax, 1] < 0]
    if flips:
        out = torch.flip(out, dims=flips)
    perm = np.argsort(ornt[:, 0]).tolist() + list(range(3, data.dim()))
    if perm != list(range(data.dim())):
        out = out.permute(*perm)
    return out.contiguous()


def inv_orientation(ornt: np.ndarray) -> np.ndarray:
    inv = np.zeros_like(ornt)
    for i in range(3):
        out_ax = int(ornt[i, 0])
        inv[out_ax, 0] = i
        inv[out_ax, 1] = ornt[i, 1]
    return inv


def orientation_affine(ornt: np.ndarray, shape) -> np.ndarray:
    """Affine mapping array indices after reorientation to indices before."""
    undo_flip = np.eye(4)
    for ax in range(3):
        if ornt[ax, 1] < 0:
            undo_flip[ax, ax] = -1
            undo_flip[ax, 3] = shape[ax] - 1
    perm = np.argsort(ornt[:, 0])
    perm_aff = np.zeros((4, 4))
    perm_aff[3, 3] = 1
    for out_ax, in_ax in enumerate(perm):
        perm_aff[in_ax, out_ax] = 1
    return undo_flip @ perm_aff


def canonical_geometry(img: NiftiImage):
    """(ornt, canonical affine, canonical shape, canonical zooms), from the
    affine alone."""
    ornt = io_orientation(img.affine)
    new_affine = img.affine @ orientation_affine(ornt, img.shape)
    perm = np.argsort(ornt[:, 0])
    shape = tuple(int(np.asarray(img.shape)[p]) for p in perm)
    zooms = tuple(float(np.sqrt((new_affine[:3, i] ** 2).sum())) for i in range(3))
    return ornt, new_affine, shape, zooms


def empty_like(shape: tuple[int, ...], affine: np.ndarray, dtype=np.uint8) -> NiftiImage:
    return NiftiImage(data=np.zeros(shape, dtype=dtype), affine=affine.copy())
