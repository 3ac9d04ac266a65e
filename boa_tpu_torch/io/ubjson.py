"""Minimal UBJSON (draft-12) decoder.

Counterpart of `boa_tpu/io/ubjson.py`. XGBoost saves model files in UBJSON
when it writes them through its binary path; the pickled contrast-phase
regressors hold their boosters so. This decoder covers what UBJSON defines
and XGBoost emits: scalar markers, length-prefixed strings, objects with
numeric-length keys and (strongly) typed arrays with count markers, all
numbers big-endian, from the public UBJSON spec (ubjson.org).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_SCALAR_FMT = {
    b"i": ">b", b"U": ">B", b"I": ">h", b"l": ">i", b"L": ">q",
    b"d": ">f", b"D": ">d",
}
_NP_DTYPE = {
    b"i": ">i1", b"U": ">u1", b"I": ">i2", b"l": ">i4", b"L": ">i8",
    b"d": ">f4", b"D": ">f8",
}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated UBJSON input")
        self.pos += n
        return b

    def marker(self) -> bytes:
        m = self.take(1)
        while m == b"N":  # no-op marker, skippable anywhere
            m = self.take(1)
        return m

    def number(self, marker: bytes) -> int | float:
        fmt = _SCALAR_FMT.get(marker)
        if fmt is None:
            raise ValueError(f"expected numeric marker, got {marker!r} "
                             f"at offset {self.pos - 1}")
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self) -> int:
        n = self.number(self.marker())
        if not isinstance(n, int) or n < 0:
            raise ValueError(f"invalid length {n!r}")
        return n

    def string(self) -> str:
        return self.take(self.length()).decode("utf-8")

    def value(self, marker: bytes | None = None) -> Any:
        m = marker if marker is not None else self.marker()
        if m in _SCALAR_FMT:
            return self.number(m)
        if m == b"S" or m == b"H":  # high-precision numbers kept as str
            return self.string()
        if m == b"C":
            return self.take(1).decode("latin-1")
        if m == b"T":
            return True
        if m == b"F":
            return False
        if m == b"Z":
            return None
        if m == b"[":
            return self._array()
        if m == b"{":
            return self._object()
        raise ValueError(f"unknown UBJSON marker {m!r} at {self.pos - 1}")

    def _container_header(self) -> tuple[bytes | None, int | None]:
        elem_type = None
        count = None
        m = self.marker()
        if m == b"$":
            elem_type = self.take(1)
            m = self.marker()
        if m == b"#":
            count = self.length()
            return elem_type, count
        if elem_type is not None:
            raise ValueError("typed container requires a count marker")
        # m is the first element's marker (or the end marker)
        self.pos -= 1
        return None, None

    def _array(self) -> Any:
        elem_type, count = self._container_header()
        if elem_type is not None:
            assert count is not None
            dt = _NP_DTYPE.get(elem_type)
            if dt is not None:
                arr = np.frombuffer(self.take(count * np.dtype(dt).itemsize),
                                    dtype=dt)
                return arr.astype(arr.dtype.newbyteorder("="))
            if elem_type == b"T":
                return np.ones(count, bool)
            if elem_type == b"F":
                return np.zeros(count, bool)
            if elem_type == b"Z":
                return [None] * count
            return [self.value(elem_type) for _ in range(count)]
        if count is not None:
            return [self.value() for _ in range(count)]
        out = []
        while True:
            m = self.marker()
            if m == b"]":
                return out
            out.append(self.value(m))

    def _object(self) -> dict:
        elem_type, count = self._container_header()
        out: dict[str, Any] = {}
        if count is not None:
            for _ in range(count):
                key = self.string()  # key must be read before the value
                out[key] = self.value(elem_type)
            return out
        while True:
            m = self.marker()
            if m == b"}":
                return out
            self.pos -= 1
            key = self.string()
            out[key] = self.value()


def loads(data: bytes) -> Any:
    """Decode one UBJSON value from bytes."""
    return _Reader(data).value()


def load_auto(data: bytes) -> Any:
    """Decode bytes that are either UBJSON or plain JSON text."""
    head = data.lstrip()[:1]
    if head in (b"{", b"[") and data.lstrip()[:2] not in (b"{L", b"{i", b"{U",
                                                          b"[$", b"[#"):
        try:
            import json
            return json.loads(data.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            pass
    return loads(data)
