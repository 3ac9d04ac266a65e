"""PNG writer: 8-bit RGB and RGBA images, deflated with `zlib`.

One IDAT chunk, filter type 0 on every row and zlib's default level, so the
same array always gives the same bytes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {3: 2, 4: 6}   # channels -> PNG colour type (RGB, RGBA)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 (height, width, 3 or 4) array, row 0 on top."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"need a uint8 (h, w, 3|4) array, got {a.dtype} {a.shape}")
    h, w, c = a.shape
    if h == 0 or w == 0:
        raise ValueError(f"empty image {a.shape}")
    rows = np.zeros((h, 1 + w * c), np.uint8)   # filter byte 0, then the row
    rows[:, 1:] = a.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode(img))
