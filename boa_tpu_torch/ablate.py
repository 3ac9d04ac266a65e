"""Where the stride-2 conv kernel's time goes, on the card.

    python -m boa_tpu_torch.ablate

Builds variants of `csrc/stride2conv.cu` with parts of its work taken out
(a textual substitution each), swaps each in for the package's own build
of that source, and times the wrapper's launch alone (`prepare_launch`) at
the main path's shape: 128^3 x 32 read from the skip half of the
(1, 128, 128, 128, 64) decoder concat -> 64^3 x 64. The variants compute
wrong results by design; they only say what each part costs. Prints one
JSON line per variant (two timings each, CUDA events over 20 launches)
and raises without a card or `nvcc`.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from boa_tpu_torch import _build
from boa_tpu_torch.ops import rowconv as rc

_LOADS = (r"cp_async16\(at\(buf, iy, iz\), xp \+ \(\(size_t\)gy \* Z \+ gz\) \* ldx\);", ";")
_ACT = (r"o = act8\(\*p, nrm\);", "o = *p;")
_NO_STAGING = (r"if \(live\) \{  // norm", "if (false) {  // norm")
_PRODUCTS = [(r"if \(live\) products\(", "if (false) products("),
             (r"if \(live && k \+ 1 < nplanes\) products", "if (false) products")]
_WEIGHTS = (r"b\[p\] = __ldg\(wq \+ \(step \* NB \+ p\) \* 32\);",
            "b[p] = make_uint4(lane, step, p, 1);")

#: name -> (what is left, substitutions)
VARIANTS = {
    "full": ("the kernel as it is", []),
    "no_products": ("loads, norm + act, epilogue", _PRODUCTS),
    "products_only": ("products and epilogue; the norm pass copies", [_LOADS, _ACT]),
    "products_no_weight_loads": ("products_only with B from registers",
                                 [_LOADS, _ACT, _WEIGHTS]),
    "skeleton": ("barriers, a copy pass and the epilogue", [_LOADS, _ACT] + _PRODUCTS),
    "epilogue_only": ("barriers and the epilogue", [_LOADS, _NO_STAGING] + _PRODUCTS),
}


def _variant_libs() -> dict[str, ctypes.CDLL]:
    src_path = _build.CSRC / "stride2conv.cu"
    src = src_path.read_text()
    out = _build.BUILD_ROOT / "ablate" / _build._digest()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for pat, rep in subs:
            text, k = re.subn(pat, rep, text)
            if not k:
                raise RuntimeError(f"variant {name}: {pat!r} not in {src_path.name}")
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in VARIANTS}


def _time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("boa_tpu_torch.ablate needs an NVIDIA GPU")
    libs = _build.build_all()
    own = libs["stride2conv"]
    variants = _variant_libs()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cat = torch.tensor(rng.normal(size=(1, 128, 128, 128, 64)), dtype=torch.bfloat16,
                       device=dev)
    w = torch.tensor(rng.normal(size=(3, 3, 3, 32, 64)) * 0.03, dtype=torch.bfloat16,
                     device=dev)
    b = torch.tensor(rng.normal(size=64) * 0.1, dtype=torch.bfloat16, device=dev)
    norm = rc.NormAct(torch.zeros(1, 32, device=dev), torch.ones(1, 32, device=dev),
                      torch.ones(32, device=dev), torch.zeros(32, device=dev), 0.01)
    times: dict[str, list[float]] = {}
    try:
        for _ in range(2):
            for name, lib in variants.items():
                libs["stride2conv"] = lib
                _build._declare(libs)
                launch, _ = rc.prepare_launch("conv3d_rows_stride2", cat[..., 32:], norm,
                                              w, b, slope=0.01)
                times.setdefault(name, []).append(_time_ms(launch))
    finally:
        libs["stride2conv"] = own
        _build._declare(libs)
    for name, (left, _) in VARIANTS.items():
        print(json.dumps({"variant": name, "left": left, "ms": times[name],
                          "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
