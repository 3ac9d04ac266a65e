"""Time the host frame decoders against their plain versions.

    python -m boa_tpu_torch.native.timing

Encodes one 512x512 CT slice (the bench's synthetic anatomy: air, a
soft-tissue ellipse, a dense core, noise) as RLE, JPEG Lossless SV1,
JPEG-LS, JPEG 2000 and 12-bit JPEG Extended, decodes each through the
library (`native/*.cpp`, the median of five calls) and each lossless frame
once through its plain Python decoder, and prints one JSON object with the
build seconds and each codec's times. The library must give back the
source's bits and the plain version the library's; JPEG 2000's plain
version decodes the central 128x128 crop (a full slice takes tens of
seconds). Runs on the host alone: no card. `chip_smoke.py` calls
`time_decoders` on a slice of its bench CT.
"""

from __future__ import annotations

import json
import os
import platform
import statistics
import time

import numpy as np


def bench_slice(n: int = 512) -> np.ndarray:
    """(n, n) int16 HU: one slice of the bench's synthetic anatomy."""
    g = np.linspace(-1, 1, n, dtype=np.float32)
    gx, gy = g[None, :], g[:, None]
    body = (gx ** 2 / 0.49 + gy ** 2 / 0.36) < 1.0
    core = (gx ** 2 / 0.04 + gy ** 2 / 0.04) < 1.0
    base = np.where(body, 40.0, -1000.0) + np.where(core, 660.0, 0.0)
    noise = 12.0 * np.random.default_rng(0).standard_normal((n, n), dtype=np.float32)
    return (base + noise).astype(np.int16)


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_decoders(sl: np.ndarray, reps: int = 5) -> dict:
    """Build the library and time each codec on the int16 slice `sl`;
    raises if a lossless decode differs from the source or from its plain
    version."""
    from boa_tpu_torch import native
    from boa_tpu_torch.io import dicom_codecs as dc
    from boa_tpu_torch.io import j2k

    native.build_all()
    raw = np.ascontiguousarray(sl).view(np.uint16)
    rows, cols = raw.shape
    crop = np.ascontiguousarray(raw[rows // 2 - 64:rows // 2 + 64, cols // 2 - 64:cols // 2 + 64])
    biased = np.clip(sl.astype(np.int32) + 1024, 0, 4095).astype(np.uint16)

    def j2k_plain(frame):
        return (j2k.decode(frame).astype(np.int64) & 0xFFFF).astype(np.uint16)

    # name: (source, encoder, library decode, plain version or None)
    codecs = {
        "rle": (raw, dc.encode_rle, lambda f: dc.decode_rle(f, rows, cols, 2),
                lambda f: dc._decode_rle_python(f, rows, cols, 2)),
        "jpeg_lossless_sv1": (raw, dc.encode_jpeg_lossless_sv1, dc.decode_jpeg_lossless,
                              dc._decode_jpegll_python),
        "jpeg_ls": (raw, dc.encode_jpeg_ls, dc.decode_jpeg_ls, dc._decode_jpegls_python),
        "jpeg_2000": (raw, dc.encode_jpeg2000, dc.decode_jpeg2000, j2k_plain),
        "jpeg_extended_12bit": (biased, lambda a: dc.encode_jpeg_dct(a, precision=12),
                                dc.decode_jpeg_dct, None),
    }
    out = {}
    if dc._pil_jpeg2000() is None:   # the JPEG 2000 encoder is Pillow's
        out["jpeg_2000"] = {"not_run": "Pillow with OpenJPEG is not on this host"}
        del codecs["jpeg_2000"]
    for name, (src, enc, decode, plain) in codecs.items():
        frame = enc(src)
        got = decode(frame)
        row = {"frame_bytes": len(frame), "library_ms": _median_ms(lambda: decode(frame), reps)}
        if plain is None:
            err = int(np.abs(got.astype(np.int64) - src).max())
            row.update(plain="none: no pure-Python decoder of 12-bit lossy JPEG",
                       max_abs_err_vs_source=err)
            if got.shape != src.shape or err >= 200:
                raise AssertionError(f"{name}: {row}")
        else:
            pframe, plain_on = (enc(crop), "the central 128x128 crop") if name == "jpeg_2000" \
                else (frame, f"the {rows}x{cols} slice")
            t0 = time.perf_counter()
            pgot = plain(pframe)
            row.update(plain_ms=(time.perf_counter() - t0) * 1e3, plain_on=plain_on,
                       library_equal_source=bool(np.array_equal(got, src)),
                       plain_equal_library=bool(np.array_equal(pgot, decode(pframe))))
            if not (row["library_equal_source"] and row["plain_equal_library"]):
                raise AssertionError(f"{name}: {row}")
        out[name] = row
    build = {k: native.build_info[k] for k in ("seconds", "cached")}
    return {"build": build, "codecs": out}


def main() -> None:
    sl = bench_slice()
    print(json.dumps({"host": platform.processor() or platform.machine(),
                      "cpus": os.cpu_count(), "slice": f"{sl.shape[0]}x{sl.shape[1]} int16",
                      **time_decoders(sl)}))


if __name__ == "__main__":
    main()
