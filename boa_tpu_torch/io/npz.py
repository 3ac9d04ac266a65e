"""`.npz` archives with the deflate spread over threads.

`savez_compressed` writes what `numpy.savez_compressed` writes (a zip of
`<name>.npy` members, deflate at zlib's default level, zip64), readable by
`numpy.load` and by any zip reader; only the compressed bytes differ. Each
member's data is cut into blocks that worker threads deflate independently,
each block a raw deflate stream ended by a full flush, as pigz does, so
their concatenation is one valid stream (zlib releases the GIL while it
compresses). numpy's writer runs one thread: on the 8-core host of an
NVIDIA H100 80GB HBM3 machine it took 138 s for the 1.6 GB of float16
probabilities of a 118-class 224x192x160 case, this writer 17-18 s
(PERF.md §6). Every `.npz` the port writes goes through it: the
probabilities, converted checkpoints and `io/imageio.py`'s arrays. The
archive is written to a temporary file in the target's folder and renamed
onto the target (`os.replace`) once complete, so a reader never finds a
partial archive under the target's name: not while another process writes
it, nor after a write that was interrupted.

The blocks reach the pool through the private `_compressor` attribute of
the member handle that `zipfile.ZipFile.open(name, "w")` returns: zipfile
passes every `write` through it and keeps the CRC and the sizes itself.
A zipfile that stopped reading that attribute would still write a valid
archive, one-threaded; `tests/test_torch_engine.py` fails if the pool
deflated nothing.
"""

from __future__ import annotations

import os
import uuid
import zipfile
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

BLOCK_BYTES = 4 << 20


def _deflate(data, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush(zlib.Z_FULL_FLUSH)


class _BlockDeflate:
    """The compressor of one zip member: `compress` queues a block on the
    pool and returns the blocks finished so far, in order; `flush` waits for
    the rest and ends the stream with an empty final block."""

    def __init__(self, pool: ThreadPoolExecutor, depth: int, level: int):
        self.pool, self.depth, self.level = pool, depth, level
        self.pending: deque = deque()

    def compress(self, data) -> bytes:
        self.pending.append(self.pool.submit(_deflate, data, self.level))
        out = []
        while self.pending and (len(self.pending) > self.depth or self.pending[0].done()):
            out.append(self.pending.popleft().result())
        return b"".join(out)

    def flush(self) -> bytes:
        out = [f.result() for f in self.pending]
        self.pending.clear()
        return b"".join(out) + zlib.compressobj(self.level, zlib.DEFLATED, -15).flush()


def savez_compressed(path: str | Path, **arrays) -> None:
    """`numpy.savez_compressed(path, **arrays)` on one deflating thread per
    host core, at most 8."""
    path = Path(path)
    # a name of its own per call (the umask's permissions, unlike mkstemp)
    tmp = path.with_name(f".{path.name}.{uuid.uuid4().hex}.part")
    try:
        _write(tmp, arrays)
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def _write(path: Path, arrays: dict) -> None:
    threads = max(1, min(8, os.cpu_count() or 1))
    level = zlib.Z_DEFAULT_COMPRESSION
    with ThreadPoolExecutor(threads) as pool, \
            zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, allowZip64=True) as zf:
        for name, value in arrays.items():
            arr = np.asarray(value, order="C")
            if arr.dtype.hasobject:
                raise ValueError(f"{name}: object arrays are not written")
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                # the member's compressor: zipfile keeps the CRC and sizes
                fh._compressor = _BlockDeflate(pool, 2 * threads, level)
                np.lib.format.write_array_header_1_0(
                    fh, np.lib.format.header_data_from_array_1_0(arr))
                data = memoryview(arr.reshape(-1)).cast("B")
                for start in range(0, len(data), BLOCK_BYTES):
                    fh.write(data[start:start + BLOCK_BYTES])
