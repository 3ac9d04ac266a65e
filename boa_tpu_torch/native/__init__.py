"""Build and load the host frame decoders of `native/*.cpp`.

Counterpart of `boa_tpu/native/__init__.py` for the four DICOM decoders:
JPEG Lossless SV1/P14 and RLE (`jpegll.cpp`), JPEG-LS (`jpegls.cpp`), JPEG
2000 (`jpeg2000.cpp`) and lossy JPEG, 8- and 12-bit (`jpegdct.cpp`). Each
source is self-contained (standard headers only) with an `extern "C"`
interface, and compiles with `g++` into its own shared library, loaded with
`ctypes`. The four compile in parallel at first use, never at import, into
`build/boa_tpu_torch_native/<hash>/` at the repository root, keyed on a hash
of the sources and the flags. Each library is written to a temporary file
and moved into place, so that several processes may build at once.

A failed build raises with the compiler's output: the decode path has no
quiet fallback to the pure-Python decoders of `io/dicom_codecs.py` and
`io/j2k.py`, which are the plain versions the tests compare with.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("jpegll", "jpegls", "jpeg2000", "jpegdct")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "boa_tpu_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, the directory, whether the cache was hit
build_info: dict = {}


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the DICOM frame decoders of "
                           "boa_tpu_torch need a C++17 compiler to build")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for stem in SOURCES:
        h.update(stem.encode())
        h.update((SRC_DIR / f"{stem}.cpp").read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (or load from the cache) every decoder library; stem -> CDLL."""
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for stem in SOURCES:
            so = out_dir / f"lib{stem}.so"
            if so.exists():
                continue
            tmp = out_dir / f"lib{stem}.{os.getpid()}.tmp.so"
            cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{stem}.cpp")]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, so)
        failed = {}
        for stem, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed[stem] = out
                continue
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        if failed:
            raise RuntimeError("g++ failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(out[-4000:] for out in failed.values()))
        for stem in SOURCES:
            _libs[stem] = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
        _declare(_libs)
        build_info.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                          cached=not procs)
        return _libs


def _declare(libs: dict[str, ctypes.CDLL]) -> None:
    buf, n, i32 = ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32
    out, dim = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
    for stem, name in (("jpegll", "boa_jpegll_decode"), ("jpegls", "boa_jpegls_decode"),
                       ("jpegdct", "boa_jpegdct_decode")):
        fn = getattr(libs[stem], name)
        fn.argtypes = [buf, n, out, n, dim, dim, dim, dim]
        fn.restype = i32
    fn = libs["jpegll"].boa_rle_decode
    fn.argtypes = [buf, n, out, n, i32]
    fn.restype = i32
    fn = libs["jpeg2000"].boa_j2k_decode
    fn.argtypes = [buf, n, out, n, dim, dim]
    fn.restype = i32


def lib(stem: str) -> ctypes.CDLL:
    return build_all()[stem]
