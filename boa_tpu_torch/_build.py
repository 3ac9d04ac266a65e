"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` source compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes`. All sources compile
in parallel (one `nvcc` process each) at first use, into
`build/boa_tpu_torch_kernels/<hash>/` at the repository root, keyed on a
hash of the sources and the flags, so an edit rebuilds and an unchanged
tree loads the cached libraries. Nothing is built at import time.

The build needs the CUDA toolkit (`nvcc` on PATH or under
`/usr/local/cuda/bin`); it raises when the toolkit is missing or a source
does not compile.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "boa_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, per-source nvcc logs (ptxas register,
#: shared-memory and spill report) and whether the cache was hit
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of boa_tpu_torch "
                       "need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (or load from the cache) every kernel library; name -> CDLL."""
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        procs = {}
        for src in sources:
            so = out_dir / f"lib{src.stem}.so"
            if so.exists():
                continue
            tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        logs = {}
        failed = []
        for stem, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            logs[stem] = out
            (out_dir / f"{stem}.log").write_text(out)
            if proc.returncode != 0:
                failed.append(stem)
                continue
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[s][-4000:] for s in failed))
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        _declare(_libs)
        build_info.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                          cached=not procs, logs=logs)
        return _libs


def _declare(libs: dict[str, ctypes.CDLL]) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = libs["stride2conv"].boa_stride2conv_fwd
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    fn.restype = i
    fn = libs["transpconv"].boa_transpconv2_fwd
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = i
    fn = libs["conv_in_act"].boa_conv_in_act_fwd
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
    fn.restype = i
    fn = libs["conv_in_act"].boa_conv_in_act_finish
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = i


def lib(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
