"""Just enough NIfTI-1 for the benchmark: write an uncompressed CT, read a
label volume back (`.nii` or `.nii.gz`). Little-endian, 3-D, the affine in
the sform (written with sform_code 1 and qform_code 0; read from the sform
where its code is set)."""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

_HDR = 348
_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.int32): 8,
          np.dtype(np.float32): 16, np.dtype(np.uint16): 512}
_TYPES = {v: k for k, v in _CODES.items()}


def write(path: Path, data: np.ndarray, affine: np.ndarray) -> None:
    """An uncompressed `.nii` of a 3-D array (Fortran voxel order), on disk
    before it returns (so that no write-back of it runs later, in a measured
    window)."""
    hdr = bytearray(_HDR)
    struct.pack_into("<i", hdr, 0, _HDR)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, _CODES[data.dtype], data.dtype.itemsize * 8)
    zooms = [float(np.linalg.norm(affine[:3, i])) for i in range(3)]
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, float(_HDR + 4))
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<2h", hdr, 252, 0, 1)
    for r in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * r, *affine[r, :])
    struct.pack_into("<4s", hdr, 344, b"n+1\x00")
    with open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4)
        f.write(np.asfortranarray(data).T.data)
        f.flush()
        os.fsync(f.fileno())


def read(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(data, affine) of a 3-D NIfTI-1 file."""
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if struct.unpack_from("<i", raw, 0)[0] != _HDR:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", raw, 40)
    code = struct.unpack_from("<h", raw, 70)[0]
    off = int(struct.unpack_from("<f", raw, 108)[0])
    shape = tuple(int(n) for n in dim[1:1 + dim[0]])
    dt = np.dtype(_TYPES[code])
    data = np.frombuffer(raw, dtype=dt, count=int(np.prod(shape)), offset=off)
    affine = np.eye(4)
    if struct.unpack_from("<h", raw, 254)[0] > 0:
        for r in range(3):
            affine[r, :] = struct.unpack_from("<4f", raw, 280 + 16 * r)
    else:
        affine[:3, :3] = np.diag(struct.unpack_from("<3f", raw, 80))
    return data.reshape(shape, order="F"), affine
