"""Compressed-DICOM frame codecs: JPEG Lossless, RLE, JPEG-LS, JPEG 2000
and lossy JPEG.

Counterpart of `boa_tpu/io/dicom_codecs.py`, for the transfer syntaxes
hospitals send: JPEG Lossless SV1 (1.2.840.10008.1.2.4.70) and P14 (…4.57),
RLE Lossless (…1.2.5), JPEG-LS (…4.80/.81), JPEG 2000 (…4.90/.91) and lossy
JPEG, baseline 8-bit (…4.50) and extended 12-bit (…4.51), which the
reference reads through SimpleITK/GDCM (`body_organ_analysis/compute/
io.py:326-383`). Every frame decodes through the port's C++ decoders
(`native/`, built with g++ at first use; a failed build raises). JPEG 2000
keeps the reference's order for streams its decoder rejects: the library,
then Pillow/OpenJPEG, then `io/j2k.py`. The pure-Python decoders
(`_decode_jpegll_python`, `_decode_rle_python`, `_decode_jpegls_python` and
`j2k.decode`) are the plain versions the tests hold the library against;
no decode path calls them. The encoders are pure Python, for the writer and
the round-trip tests.
"""

from __future__ import annotations

import ctypes
import logging
import struct

import numpy as np

from boa_tpu_torch import native

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# JPEG lossless decode
# ---------------------------------------------------------------------------

def decode_jpeg_lossless(frame: bytes) -> np.ndarray:
    """(rows, cols) or (rows, cols, ncomp) uint16 samples."""
    return _decode_jpegll_native(native.lib("jpegll"), frame)


def _decode_jpegll_native(lib, frame: bytes) -> np.ndarray:
    rows = ctypes.c_int32()
    cols = ctypes.c_int32()
    ncomp = ctypes.c_int32()
    prec = ctypes.c_int32()
    rc = lib.boa_jpegll_decode(frame, len(frame), None, 0,
                               ctypes.byref(rows), ctypes.byref(cols),
                               ctypes.byref(ncomp), ctypes.byref(prec))
    if rc != 0:
        raise ValueError(f"JPEG-lossless geometry parse failed (rc={rc})")
    out = np.empty(rows.value * cols.value * ncomp.value, np.uint16)
    rc = lib.boa_jpegll_decode(frame, len(frame),
                               out.ctypes.data_as(ctypes.c_void_p), out.size,
                               ctypes.byref(rows), ctypes.byref(cols),
                               ctypes.byref(ncomp), ctypes.byref(prec))
    if rc != 0:
        raise ValueError(f"JPEG-lossless decode failed (rc={rc})")
    out = out.reshape(rows.value, cols.value, ncomp.value)
    return out[:, :, 0] if ncomp.value == 1 else out


class _Bits:
    """MSB-first bit reader with JPEG 0xFF00 byte unstuffing."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0

    def _fill(self) -> None:
        b = self.data[self.pos]
        self.pos += 1
        if b == 0xFF:
            self.pos += 1  # skip stuffed 0x00 (markers end the scan)
        self.acc = (self.acc << 8) | b
        self.n += 8

    def read(self, k: int) -> int:
        while self.n < k:
            self._fill()
        self.n -= k
        v = (self.acc >> self.n) & ((1 << k) - 1)
        self.acc &= (1 << self.n) - 1
        return v


def _decode_jpegll_python(frame: bytes) -> np.ndarray:
    """The plain version of the library's decoder (slow); single or
    multi-component, 1x1 sampling."""
    pos = 2  # past SOI
    tables: dict[int, tuple[list[int], list[int], list[int], list[int]]] = {}
    precision = rows = cols = 0
    comp_ids: list[int] = []
    comp_dc: dict[int, int] = {}
    while pos < len(frame):
        assert frame[pos] == 0xFF, "marker expected"
        marker = frame[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        seg = struct.unpack(">H", frame[pos:pos + 2])[0]
        body = frame[pos + 2:pos + seg]
        if marker == 0xDD and struct.unpack(">H", body[:2])[0] != 0:
            # restart intervals: _Bits treats every 0xFF as stuffing, so a
            # RST marker would silently desync the Huffman stream — refuse
            # rather than return corrupt pixels (the library's decoder
            # handles DRI)
            raise ValueError(
                "JPEG-lossless restart intervals (DRI) are unsupported by "
                "the python decoder; decode_jpeg_lossless handles them")
        if marker in (0xC3, 0xC7, 0xCB, 0xCF):  # SOF3 family
            precision = body[0]
            rows, cols = struct.unpack(">HH", body[1:5])
            ncomp = body[5]
            comp_ids = [body[6 + 3 * c] for c in range(ncomp)]
        elif marker == 0xC4:  # DHT
            off = 0
            while off < len(body):
                th = body[off] & 15
                counts = list(body[off + 1:off + 17])
                nv = sum(counts)
                vals = list(body[off + 17:off + 17 + nv])
                mincode, maxcode, valptr = [0] * 17, [-1] * 17, [0] * 17
                code = k = 0
                for ln in range(1, 17):
                    valptr[ln] = k
                    mincode[ln] = code
                    code += counts[ln - 1]
                    k += counts[ln - 1]
                    maxcode[ln] = code - 1 if counts[ln - 1] else -1
                    code <<= 1
                tables[th] = (mincode, maxcode, valptr, vals)
                off += 17 + nv
        elif marker == 0xDA:  # SOS
            ns = body[0]
            scan = []
            for c in range(ns):
                cid = body[1 + 2 * c]
                scan.append(comp_ids.index(cid))
                comp_dc[comp_ids.index(cid)] = body[2 + 2 * c] >> 4
            predictor = body[1 + 2 * ns]
            pt = body[3 + 2 * ns] & 15
            data = frame[pos + seg:]
            return _jpegll_scan(data, rows, cols, len(comp_ids), scan,
                                comp_dc, tables, precision, predictor, pt)
        pos += seg
    raise ValueError("no SOS marker in JPEG stream")


def _jpegll_scan(data, rows, cols, ncomp, scan, comp_dc, tables, precision,
                 predictor, pt) -> np.ndarray:
    br = _Bits(data)

    def huff(th):
        mincode, maxcode, valptr, vals = tables[th]
        code = br.read(1)
        for ln in range(1, 17):
            if maxcode[ln] >= 0 and code <= maxcode[ln]:
                return vals[valptr[ln] + code - mincode[ln]]
            code = (code << 1) | br.read(1)
        raise ValueError("bad huffman code")

    # prediction runs in the UNSHIFTED (precision - pt bit) domain; the
    # point-transform shift applies only to the final output (T.81 H.2.1 —
    # storing shifted values back into the neighborhood would corrupt
    # every later prediction and overflow the uint16 store)
    out = np.zeros((rows, cols, ncomp), np.uint16)
    default = 1 << (precision - pt - 1)
    for y in range(rows):
        for x in range(cols):
            for c in scan:
                ssss = huff(comp_dc[c])
                if ssss == 16:
                    diff = 32768
                else:
                    v = br.read(ssss) if ssss else 0
                    diff = v if ssss == 0 or v >= (1 << (ssss - 1)) else \
                        v - (1 << ssss) + 1
                if y == 0 and x == 0:
                    pred = default
                elif y == 0:
                    pred = int(out[0, x - 1, c])
                elif x == 0:
                    pred = int(out[y - 1, 0, c])
                else:
                    ra = int(out[y, x - 1, c])
                    rb = int(out[y - 1, x, c])
                    rc_ = int(out[y - 1, x - 1, c])
                    pred = {1: ra, 2: rb, 3: rc_, 4: ra + rb - rc_,
                            5: ra + ((rb - rc_) >> 1),
                            6: rb + ((ra - rc_) >> 1),
                            7: (ra + rb) >> 1}[predictor]
                out[y, x, c] = (pred + diff) & 0xFFFF
    if pt:
        out <<= pt
    return out[:, :, 0] if ncomp == 1 else out


# ---------------------------------------------------------------------------
# JPEG lossless encode (SV1: predictor 1, Pt 0) — pure python
# ---------------------------------------------------------------------------

#: fixed valid Huffman lengths for the 17 SSSS symbols: three 2-bit codes,
#: then one code per length 3..16 (Kraft sum 1 - 2^-16: all-ones unused)
_ENC_COUNTS = [0, 3] + [1] * 14
_ENC_SYMBOLS = list(range(17))


def _enc_table() -> dict[int, tuple[int, int]]:
    table = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(_ENC_COUNTS[ln - 1]):
            table[_ENC_SYMBOLS[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return table


def encode_jpeg_lossless_sv1(img: np.ndarray, precision: int = 16) -> bytes:
    """Encode a 2-D unsigned array as JPEG lossless, SV1 (Ra predictor)."""
    img = np.ascontiguousarray(img, np.uint16)
    rows, cols = img.shape
    table = _enc_table()

    # differences: (0,0) vs 2^(P-1); first row vs Ra; first col vs Rb;
    # rest vs Ra (selection value 1)
    work = img.astype(np.int32)
    diffs = np.empty_like(work)
    diffs[0, 0] = work[0, 0] - (1 << (precision - 1))
    diffs[0, 1:] = work[0, 1:] - work[0, :-1]
    diffs[1:, 0] = work[1:, 0] - work[:-1, 0]
    diffs[1:, 1:] = work[1:, 1:] - work[1:, :-1]
    diffs = ((diffs + 32768) & 0xFFFF) - 32768  # mod-2^16 wraparound

    bits = bytearray()
    acc = 0
    nbits = 0

    def put(value: int, length: int) -> None:
        nonlocal acc, nbits
        acc = (acc << length) | (value & ((1 << length) - 1))
        nbits += length
        while nbits >= 8:
            nbits -= 8
            byte = (acc >> nbits) & 0xFF
            bits.append(byte)
            if byte == 0xFF:
                bits.append(0x00)
        acc &= (1 << nbits) - 1

    for diff in diffs.ravel():
        d = int(diff)
        if d == 32768 or d == -32768:
            code, ln = table[16]
            put(code, ln)
            continue
        mag = abs(d)
        ssss = mag.bit_length()
        code, ln = table[ssss]
        put(code, ln)
        if ssss:
            put(d if d >= 0 else d + (1 << ssss) - 1, ssss)
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)  # pad with 1s

    dht_vals = bytes([0x00] + _ENC_COUNTS + _ENC_SYMBOLS)
    out = bytearray(b"\xff\xd8")  # SOI
    out += b"\xff\xc4" + struct.pack(">H", 2 + len(dht_vals)) + dht_vals
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += b"\xff\xc3" + struct.pack(">H", 2 + len(sof)) + sof
    sos = bytes([1, 1, 0x00, 1, 0, 0x00])  # 1 comp, Ss=1 (SV1), Al=0
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    out += bits
    out += b"\xff\xd9"  # EOI
    return bytes(out)


# ---------------------------------------------------------------------------
# DICOM RLE (PS3.5 Annex G)
# ---------------------------------------------------------------------------

def decode_rle(frame: bytes, rows: int, cols: int,
               bytes_per_sample: int) -> np.ndarray:
    """Recompose an RLE frame into (rows, cols) little-endian samples."""
    npix = rows * cols
    out = np.empty(npix * bytes_per_sample, np.uint8)
    rc = native.lib("jpegll").boa_rle_decode(
        frame, len(frame), out.ctypes.data_as(ctypes.c_void_p), npix,
        bytes_per_sample)
    if rc != 0:
        raise ValueError(f"RLE decode failed (rc={rc})")
    dt = {1: np.uint8, 2: np.uint16}[bytes_per_sample]
    return out.view(dt).reshape(rows, cols)


def _packbits_decode(seg: bytes, expect: int) -> bytes:
    out = bytearray()
    pos = 0
    while pos < len(seg) and len(out) < expect:
        n = struct.unpack_from("b", seg, pos)[0]
        pos += 1
        if n >= 0:
            out += seg[pos:pos + n + 1]
            pos += n + 1
        elif n != -128:
            out += seg[pos:pos + 1] * (1 - n)
            pos += 1
    if len(out) < expect:
        raise ValueError("RLE segment shorter than expected")
    return bytes(out[:expect])


def _decode_rle_python(frame, rows, cols, bytes_per_sample) -> np.ndarray:
    header = struct.unpack("<16I", frame[:64])
    nseg = header[0]
    if nseg != bytes_per_sample:
        raise ValueError(f"RLE segments {nseg} != bytes/sample "
                         f"{bytes_per_sample}")
    npix = rows * cols
    planes = []
    for s in range(nseg):
        start = header[1 + s]
        end = header[2 + s] if s + 1 < nseg else len(frame)
        planes.append(np.frombuffer(
            _packbits_decode(frame[start:end], npix), np.uint8))
    # segment 0 = MSB plane; compose little-endian
    out = np.zeros(npix, np.uint16 if bytes_per_sample == 2 else np.uint8)
    for s, plane in enumerate(planes):
        shift = 8 * (bytes_per_sample - 1 - s)
        out |= plane.astype(out.dtype) << shift
    return out.reshape(rows, cols)


def _packbits_encode(plane: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(plane)
    while i < n:
        # find run length at i
        run = 1
        while i + run < n and run < 128 and plane[i + run] == plane[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)  # -(run-1) as unsigned byte
            out.append(plane[i])
            i += run
            continue
        # literal stretch: until a run of >=3 starts (2-byte runs are not
        # worth breaking a literal for)
        lit = i
        while i < n and i - lit < 128:
            run = 1
            while i + run < n and run < 3 and plane[i + run] == plane[i]:
                run += 1
            if run >= 3:
                break
            i += 1
        out.append(i - lit - 1)
        out += plane[lit:i]
    if len(out) % 2:
        out.append(0)  # segments must be even-length
    return bytes(out)


def encode_rle(img: np.ndarray) -> bytes:
    """Encode (rows, cols) uint8/uint16 samples as one RLE frame."""
    img = np.ascontiguousarray(img)
    bps = img.dtype.itemsize
    if bps > 2:
        raise ValueError("RLE encoder supports 1- or 2-byte samples")
    flat = img.view(np.uint8).reshape(-1, bps)
    segments = []
    for s in range(bps):
        plane = flat[:, bps - 1 - s].tobytes()  # MSB plane first
        segments.append(_packbits_encode(plane))
    header = [len(segments)]
    off = 64
    for seg in segments:
        header.append(off)
        off += len(seg)
    header += [0] * (16 - len(header))
    body = struct.pack("<16I", *header) + b"".join(segments)
    return body + (b"\x00" if len(body) % 2 else b"")


# ---------------------------------------------------------------------------
# JPEG-LS (ITU-T T.87 / ISO 14495-1) — native decode via native/jpegls.cpp,
# pure-python fallback decoder + encoder (NEAR=0) for round-trip tests.
# Single-component scans (DICOM CT/MR frames).
# ---------------------------------------------------------------------------

_JLS_J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
          4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def decode_jpeg_ls(frame: bytes) -> np.ndarray:
    """(rows, cols) uint16 samples from one JPEG-LS codestream."""
    rows, cols = ctypes.c_int32(), ctypes.c_int32()
    ncomp, prec = ctypes.c_int32(), ctypes.c_int32()
    # geometry pass needs the real buffer in JPEG-LS (entropy data is
    # context-adaptive), so parse SOF here for the allocation
    geo = _jls_parse_headers(frame)
    out = np.empty(geo["rows"] * geo["cols"], np.uint16)
    rc = native.lib("jpegls").boa_jpegls_decode(
        frame, len(frame), out.ctypes.data_as(ctypes.c_void_p), out.size,
        ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(ncomp),
        ctypes.byref(prec))
    if rc != 0:
        raise ValueError(f"JPEG-LS decode failed (rc={rc})")
    return out.reshape(rows.value, cols.value)


def _jls_parse_headers(frame: bytes) -> dict:
    """SOF55/LSE/SOS header scan; returns geometry + coding params."""
    if frame[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG-LS stream (no SOI)")
    pos = 2
    info: dict = {"reset": 64, "maxval": 0, "t1": 0, "t2": 0, "t3": 0}
    while pos + 2 <= len(frame):
        if frame[pos] != 0xFF:
            raise ValueError("marker expected")
        marker = frame[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        seg = struct.unpack(">H", frame[pos:pos + 2])[0]
        body = frame[pos + 2:pos + seg]
        if marker == 0xF7:  # SOF55
            info["precision"] = body[0]
            info["rows"], info["cols"] = struct.unpack(">HH", body[1:5])
            info["ncomp"] = body[5]
        elif marker == 0xF8:  # LSE
            if body[0] != 1:
                raise ValueError("JPEG-LS mapping tables unsupported")
            (info["maxval"], info["t1"], info["t2"], info["t3"],
             info["reset"]) = struct.unpack(">5H", body[1:11])
        elif marker == 0xDA:  # SOS
            ns = body[0]
            if ns != 1 or info.get("ncomp") != 1:
                raise ValueError("only single-component JPEG-LS supported")
            info["near"] = body[1 + 2 * ns]
            if body[2 + 2 * ns] != 0:
                raise ValueError("interleaved JPEG-LS unsupported")
            info["data_at"] = pos + seg
            return info
        pos += seg
    raise ValueError("no SOS marker in JPEG-LS stream")


def _jls_params(info: dict) -> dict:
    """Derived coding parameters (T.87 C.2.4.1): thresholds, LIMIT, qbpp."""
    maxval = info["maxval"] or (1 << info["precision"]) - 1
    near = info["near"]
    rng = (maxval + 2 * near) // (2 * near + 1) + 1
    qbpp = max(1, (rng - 1).bit_length())
    bpp = max(2, (maxval).bit_length())
    limit = 2 * (bpp + max(8, bpp))
    bt1, bt2, bt3 = 3, 7, 21
    if maxval >= 128:
        f = (min(maxval, 4095) + 128) // 256
        t1, t2 = f * (bt1 - 2) + 2 + 3 * near, f * (bt2 - 3) + 3 + 5 * near
        t3 = f * (bt3 - 4) + 4 + 7 * near
    else:
        f = 256 // (maxval + 1)
        t1 = max(2, bt1 // f) + 3 * near
        t2, t3 = max(3, bt2 // f) + 5 * near, max(4, bt3 // f) + 7 * near
    if t1 > maxval or t1 < near + 1:
        t1 = near + 1
    t1 = info["t1"] or t1
    t2 = info["t2"] or (t1 if (t2 > maxval or t2 < t1) else t2)
    t3 = info["t3"] or (t2 if (t3 > maxval or t3 < t2) else t3)
    return {"maxval": maxval, "near": near, "range": rng, "qbpp": qbpp,
            "limit": limit, "reset": info["reset"] or 64,
            "t1": t1, "t2": t2, "t3": t3}


class _LsBits:
    """MSB-first reader with JPEG-LS unstuffing: a byte after 0xFF
    carries 7 payload bits (stuffed 0 MSB); 0xFF + MSB-set byte = marker."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0
        self.prev_ff = False
        self.marker = False

    def next(self) -> int:
        if self.pos >= len(self.data):
            self.marker = True
            return 0
        cur = self.data[self.pos]
        first = 1 if self.prev_ff else 0
        if first and self.bit == 0 and (cur & 0x80):
            self.marker = True
            return 0
        b = (cur >> (7 - (self.bit + first))) & 1
        self.bit += 1
        if self.bit == 8 - first:
            self.bit = 0
            self.prev_ff = cur == 0xFF
            self.pos += 1
        return b

    def read(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.next()
        return v


def _jls_golomb_read(br: "_LsBits", k: int, lim: int, qbpp: int) -> int:
    u = 0
    while br.next() == 0:
        u += 1
        if br.marker or u > lim:
            raise ValueError("truncated JPEG-LS stream")
    if u < lim - qbpp - 1:
        return (u << k) | br.read(k)
    return br.read(qbpp) + 1


def _jls_quantize(d: int, p: dict) -> int:
    if d <= -p["t3"]:
        return -4
    if d <= -p["t2"]:
        return -3
    if d <= -p["t1"]:
        return -2
    if d < -p["near"]:
        return -1
    if d <= p["near"]:
        return 0
    if d < p["t1"]:
        return 1
    if d < p["t2"]:
        return 2
    if d < p["t3"]:
        return 3
    return 4


def _decode_jpegls_python(frame: bytes) -> np.ndarray:
    """The plain version of the library's decoder, step for step
    (slow)."""
    info = _jls_parse_headers(frame)
    p = _jls_params(info)
    rows, cols = info["rows"], info["cols"]
    maxval, near, rng = p["maxval"], p["near"], p["range"]
    qbpp, limit, reset = p["qbpp"], p["limit"], p["reset"]
    a0 = max(2, (rng + 32) // 64)
    A = [a0] * 367
    N = [1] * 367
    B = [0] * 365
    C = [0] * 365
    Nn = [0, 0]
    ri = 0

    def fix(v: int) -> int:
        if v < -near:
            v += rng * (2 * near + 1)
        elif v > maxval + near:
            v -= rng * (2 * near + 1)
        return min(max(v, 0), maxval)

    br = _LsBits(frame[info["data_at"]:])
    out = np.empty((rows, cols), np.uint16)
    prev = [0] * (cols + 2)
    cur = [0] * (cols + 2)
    for row in range(rows):
        cur[0] = prev[1]
        prev[cols + 1] = prev[cols]
        col = 1
        while col <= cols:
            ra, rb = cur[col - 1], prev[col]
            rc, rd = prev[col - 1], prev[col + 1]
            q1 = _jls_quantize(rd - rb, p)
            q2 = _jls_quantize(rb - rc, p)
            q3 = _jls_quantize(rc - ra, p)
            if q1 == 0 and q2 == 0 and q3 == 0:  # run mode (A.7)
                rem = cols - col + 1
                while rem > 0:
                    if br.next() == 1:
                        if br.marker:
                            raise ValueError("truncated JPEG-LS run")
                        cnt = 1 << _JLS_J[ri]
                        if cnt <= rem:
                            for _ in range(cnt):
                                cur[col] = ra
                                col += 1
                            rem -= cnt
                            if ri < 31:
                                ri += 1
                            if rem == 0:
                                break
                        else:
                            for _ in range(rem):
                                cur[col] = ra
                                col += 1
                            rem = 0
                            break
                    else:
                        if br.marker:
                            raise ValueError("truncated JPEG-LS run")
                        rcnt = br.read(_JLS_J[ri]) if _JLS_J[ri] else 0
                        if rcnt > rem - 1:
                            raise ValueError("JPEG-LS run overruns line")
                        for _ in range(rcnt):
                            cur[col] = ra
                            col += 1
                        rb2, ra2 = prev[col], cur[col - 1]
                        ritype = 1 if abs(ra2 - rb2) <= near else 0
                        px = ra2 if ritype else rb2
                        ctx = 365 + ritype
                        temp = A[ctx] + (N[ctx] >> 1 if ritype else 0)
                        k = 0
                        while (N[ctx] << k) < temp:
                            k += 1
                        em = _jls_golomb_read(br, k,
                                              limit - _JLS_J[ri] - 1, qbpp)
                        tmp2 = em + ritype
                        mp = tmp2 & 1
                        eabs = (tmp2 + mp) // 2
                        cond = 1 if (k != 0 or 2 * Nn[ritype] >= N[ctx]) else 0
                        errval = -eabs if cond == mp else eabs
                        if errval < 0:
                            Nn[ritype] += 1
                        A[ctx] += (em + 1 - ritype) >> 1
                        if N[ctx] == reset:
                            A[ctx] >>= 1
                            N[ctx] >>= 1
                            Nn[ritype] >>= 1
                        N[ctx] += 1
                        e = errval * (2 * near + 1)
                        rx = px + e if (ritype or rb2 > ra2) else px - e
                        cur[col] = fix(rx)
                        col += 1
                        if ri > 0:
                            ri -= 1
                        break
                continue
            # regular mode (A.4-A.6)
            q = q1 * 81 + q2 * 9 + q3
            sign = 1
            if q < 0:
                sign, q = -1, -q
            q -= 1
            if rc >= max(ra, rb):
                px = min(ra, rb)
            elif rc <= min(ra, rb):
                px = max(ra, rb)
            else:
                px = ra + rb - rc
            px = min(max(px + sign * C[q], 0), maxval)
            k = 0
            while (N[q] << k) < A[q]:
                k += 1
            m = _jls_golomb_read(br, k, limit, qbpp)
            errval = -((m >> 1) + 1) if (m & 1) else (m >> 1)
            if k == 0 and near == 0 and 2 * B[q] <= -N[q]:
                errval = -errval - 1
            B[q] += errval * (2 * near + 1)
            A[q] += abs(errval)
            if N[q] == reset:
                A[q] >>= 1
                B[q] = B[q] >> 1 if B[q] >= 0 else -((1 - B[q]) >> 1)
                N[q] >>= 1
            N[q] += 1
            if B[q] <= -N[q]:
                B[q] += N[q]
                if C[q] > -128:
                    C[q] -= 1
                if B[q] <= -N[q]:
                    B[q] = -N[q] + 1
            elif B[q] > 0:
                B[q] -= N[q]
                if C[q] < 127:
                    C[q] += 1
                if B[q] > 0:
                    B[q] = 0
            cur[col] = fix(px + sign * errval * (2 * near + 1))
            col += 1
        prev, cur = cur, prev
        out[row] = prev[1:cols + 1]
    return out


class _LsBitWriter:
    """MSB-first writer with JPEG-LS bit stuffing (7-bit byte after 0xFF)."""

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0
        self.cap = 8

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == self.cap:
                self.out.append(self.cur)
                self.cap = 7 if self.cur == 0xFF else 8
                self.cur = 0
                self.nbits = 0

    def flush(self) -> bytes:
        if self.nbits:
            self.out.append(self.cur << (self.cap - self.nbits))
        return bytes(self.out)


def encode_jpeg_ls(img: np.ndarray, precision: int | None = None) -> bytes:
    """Lossless (NEAR=0) single-component JPEG-LS codestream of a 2-D
    unsigned array — the encoder mirror of the decoders above, used by the
    writer and the round-trip tests."""
    img = np.ascontiguousarray(img, np.uint16)
    rows, cols = img.shape
    if precision is None:
        precision = max(2, int(img.max()).bit_length())
    p = _jls_params({"precision": precision, "maxval": 0, "near": 0,
                     "t1": 0, "t2": 0, "t3": 0, "reset": 64})
    maxval, rng = p["maxval"], p["range"]
    qbpp, limit, reset = p["qbpp"], p["limit"], p["reset"]
    half = (rng + 1) // 2
    a0 = max(2, (rng + 32) // 64)
    A = [a0] * 367
    N = [1] * 367
    B = [0] * 365
    C = [0] * 365
    Nn = [0, 0]
    ri = 0
    bw = _LsBitWriter()

    def golomb_put(m: int, k: int, lim: int) -> None:
        hi = m >> k
        if hi < lim - qbpp - 1:
            bw.put(1, hi + 1)  # hi zeros then a 1
            if k:
                bw.put(m & ((1 << k) - 1), k)
        else:
            bw.put(1, lim - qbpp)
            bw.put(m - 1, qbpp)

    line = img.astype(np.int64)
    prev = [0] * (cols + 2)
    cur = [0] * (cols + 2)
    for row in range(rows):
        x = line[row]
        cur[0] = prev[1]
        prev[cols + 1] = prev[cols]
        col = 1
        while col <= cols:
            ra, rb = cur[col - 1], prev[col]
            rc, rd = prev[col - 1], prev[col + 1]
            q1 = _jls_quantize(rd - rb, p)
            q2 = _jls_quantize(rb - rc, p)
            q3 = _jls_quantize(rc - ra, p)
            if q1 == 0 and q2 == 0 and q3 == 0:  # run mode
                start = col
                while col <= cols and int(x[col - 1]) == ra:
                    cur[col] = ra
                    col += 1
                runcnt = col - start
                while runcnt >= (1 << _JLS_J[ri]):
                    bw.put(1, 1)
                    runcnt -= 1 << _JLS_J[ri]
                    if ri < 31:
                        ri += 1
                if col > cols:  # run to end of line
                    if runcnt > 0:
                        bw.put(1, 1)
                    continue
                bw.put(0, 1)
                if _JLS_J[ri]:
                    bw.put(runcnt, _JLS_J[ri])
                # run interruption sample
                xi = int(x[col - 1])
                rb2, ra2 = prev[col], cur[col - 1]
                ritype = 1 if ra2 == rb2 else 0
                px = ra2 if ritype else rb2
                errval = xi - px
                if ritype == 0 and ra2 > rb2:
                    errval = -errval
                if errval < 0:
                    errval += rng
                if errval >= half:
                    errval -= rng
                ctx = 365 + ritype
                temp = A[ctx] + (N[ctx] >> 1 if ritype else 0)
                k = 0
                while (N[ctx] << k) < temp:
                    k += 1
                cond = 1 if (k != 0 or 2 * Nn[ritype] >= N[ctx]) else 0
                if errval < 0:
                    mp = cond
                elif errval > 0:
                    mp = 1 - cond
                else:
                    mp = 0
                em = 2 * abs(errval) - ritype - mp
                golomb_put(em, k, limit - _JLS_J[ri] - 1)
                if errval < 0:
                    Nn[ritype] += 1
                A[ctx] += (em + 1 - ritype) >> 1
                if N[ctx] == reset:
                    A[ctx] >>= 1
                    N[ctx] >>= 1
                    Nn[ritype] >>= 1
                N[ctx] += 1
                cur[col] = xi
                col += 1
                if ri > 0:
                    ri -= 1
                continue
            # regular mode
            q = q1 * 81 + q2 * 9 + q3
            sign = 1
            if q < 0:
                sign, q = -1, -q
            q -= 1
            if rc >= max(ra, rb):
                px = min(ra, rb)
            elif rc <= min(ra, rb):
                px = max(ra, rb)
            else:
                px = ra + rb - rc
            px = min(max(px + sign * C[q], 0), maxval)
            xi = int(x[col - 1])
            errval = xi - px
            if sign < 0:
                errval = -errval
            if errval < 0:
                errval += rng
            if errval >= half:
                errval -= rng
            k = 0
            while (N[q] << k) < A[q]:
                k += 1
            if k == 0 and 2 * B[q] <= -N[q]:
                m = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                m = 2 * errval if errval >= 0 else -2 * errval - 1
            golomb_put(m, k, limit)
            B[q] += errval
            A[q] += abs(errval)
            if N[q] == reset:
                A[q] >>= 1
                B[q] = B[q] >> 1 if B[q] >= 0 else -((1 - B[q]) >> 1)
                N[q] >>= 1
            N[q] += 1
            if B[q] <= -N[q]:
                B[q] += N[q]
                if C[q] > -128:
                    C[q] -= 1
                if B[q] <= -N[q]:
                    B[q] = -N[q] + 1
            elif B[q] > 0:
                B[q] -= N[q]
                if C[q] < 127:
                    C[q] += 1
                if B[q] > 0:
                    B[q] = 0
            cur[col] = xi
            col += 1
        prev, cur = cur, prev

    data = bw.flush()
    out = bytearray(b"\xff\xd8")  # SOI
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += b"\xff\xf7" + struct.pack(">H", 2 + len(sof)) + sof
    sos = bytes([1, 1, 0x00, 0, 0, 0x00])  # 1 comp, NEAR=0, ILV=0
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    out += data
    out += b"\xff\xd9"  # EOI
    return bytes(out)


# ---------------------------------------------------------------------------
# JPEG 2000 (ISO/IEC 15444-1) — three decode paths, in the reference's
# order: the port's library (native/jpeg2000.cpp), the Pillow/OpenJPEG
# binding for a stream the library rejects (same backend family as the
# reference's GDCM read, compute/io.py:326-383), and the pure-Python
# decoder (io/j2k.py). DICOM frames carry a raw J2K codestream (SOC = FF4F);
# the encoder (tests, transcoding) emits the same raw codestream with the
# reversible 5/3 wavelet so lossless round-trips are exact.
# ---------------------------------------------------------------------------


def _j2k_frame_dims(frame: bytes) -> tuple[int, int]:
    """(rows, cols) from the SIZ marker (for output allocation)."""
    if frame[:2] != b"\xff\x4f":
        raise ValueError("not a raw J2K codestream (missing SOC)")
    pos = 2
    while pos + 4 <= len(frame):
        if frame[pos] != 0xFF:
            break
        marker = frame[pos + 1]
        ln = int.from_bytes(frame[pos + 2:pos + 4], "big")
        if marker == 0x51:
            seg = frame[pos + 4:pos + 2 + ln]
            xsiz = int.from_bytes(seg[2:6], "big")
            ysiz = int.from_bytes(seg[6:10], "big")
            xo = int.from_bytes(seg[10:14], "big")
            yo = int.from_bytes(seg[14:18], "big")
            return ysiz - yo, xsiz - xo
        pos += 2 + ln
    raise ValueError("missing SIZ marker")


def _decode_j2k_native(frame: bytes) -> np.ndarray:
    lib = native.lib("jpeg2000")
    rows_, cols_ = _j2k_frame_dims(frame)
    out = np.empty(rows_ * cols_, np.uint16)
    rows, cols = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.boa_j2k_decode(frame, len(frame),
                            out.ctypes.data_as(ctypes.c_void_p), out.size,
                            ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"native J2K decode failed (rc={rc})")
    return out.reshape(rows.value, cols.value)


def _pil_jpeg2000():
    try:
        from PIL import Image, features
    except ImportError:
        return None
    if not features.check("jpg_2000"):
        return None
    return Image


def decode_jpeg2000(frame: bytes) -> np.ndarray:
    """(rows, cols) uint16/uint8 bit pattern from one J2K codestream.

    Signed components come back as the 16-bit two's-complement pattern;
    the caller reinterprets per PixelRepresentation (io/dicom.py)."""
    import io as _io

    try:
        return _decode_j2k_native(frame)
    except ValueError:
        logger.debug("native J2K decode failed; falling back", exc_info=True)
    Image = _pil_jpeg2000()
    if Image is not None:
        arr = np.array(Image.open(_io.BytesIO(frame)))
        if arr.ndim != 2:
            raise ValueError(f"expected a single-component J2K frame, got "
                             f"shape {arr.shape}")
        if arr.dtype in (np.int32, np.uint32, np.int16):
            arr = (arr.astype(np.int64) & 0xFFFF).astype(np.uint16)
        return arr
    from boa_tpu_torch.io import j2k

    return (j2k.decode(frame).astype(np.int64) & 0xFFFF).astype(np.uint16)


def encode_jpeg2000(img: np.ndarray) -> bytes:
    """Lossless (reversible 5/3) raw J2K codestream of one frame."""
    import io as _io

    Image = _pil_jpeg2000()
    if Image is None:
        raise ValueError("JPEG 2000 encoding needs Pillow with OpenJPEG")
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG2000", irreversible=False,
                              no_jp2=True)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# JPEG DCT (lossy): baseline SOF0 (…4.50) and extended 12-bit SOF1 (…4.51)
# ---------------------------------------------------------------------------

_JDCT_ZIGZAG = np.array([
    0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# Annex K.1 luminance quantization table (natural order via zigzag below)
_JDCT_STD_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)  # natural (row-major) order


def _jdct_basis() -> np.ndarray:
    u = np.arange(8.0)[:, None]
    x = np.arange(8.0)[None, :]
    b = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16.0)
    b[0] *= np.sqrt(0.5)
    return b  # B[u, x]; spatial = B.T @ F @ B, F = B @ spatial @ B.T


def decode_jpeg_dct(frame: bytes) -> np.ndarray:
    """Decode a lossy (sequential-Huffman DCT) JPEG frame to uint16
    samples, (rows, cols) or (rows, cols, ncomp), 8- or 12-bit, through the
    library (`native/jpegdct.cpp`)."""
    lib = native.lib("jpegdct")
    rows = ctypes.c_int32()
    cols = ctypes.c_int32()
    ncomp = ctypes.c_int32()
    prec = ctypes.c_int32()
    rc = lib.boa_jpegdct_decode(frame, len(frame), None, 0,
                                ctypes.byref(rows), ctypes.byref(cols),
                                ctypes.byref(ncomp), ctypes.byref(prec))
    if rc != 0:
        raise ValueError(f"JPEG DCT geometry parse failed (rc={rc})")
    out = np.empty(rows.value * cols.value * ncomp.value, np.uint16)
    rc = lib.boa_jpegdct_decode(
        frame, len(frame), out.ctypes.data_as(ctypes.c_void_p),
        out.size, ctypes.byref(rows), ctypes.byref(cols),
        ctypes.byref(ncomp), ctypes.byref(prec))
    if rc != 0:
        raise ValueError(f"JPEG DCT decode failed (rc={rc})")
    out = out.reshape(rows.value, cols.value, ncomp.value)
    return out[:, :, 0] if ncomp.value == 1 else out


def _jdct_category(v: int) -> int:
    return int(abs(v)).bit_length()


class _JdctHuff:
    """Canonical Huffman writer table built from fixed code lengths."""

    def __init__(self, lengths_values: list[tuple[int, int]]):
        # lengths_values: (bit length, symbol) sorted by (length, order)
        self.codes: dict[int, tuple[int, int]] = {}
        code = 0
        last_len = 0
        counts = [0] * 17
        values = []
        for ln, sym in lengths_values:
            code <<= (ln - last_len)
            self.codes[sym] = (code, ln)
            code += 1
            last_len = ln
            counts[ln] += 1
            values.append(sym)
        self.counts = counts[1:]
        self.values = values

    def dht_payload(self, tc: int, th: int) -> bytes:
        return bytes([tc << 4 | th] + self.counts + self.values)


class _JdctBitWriter:
    """MSB-first writer with T.81 byte stuffing (0x00 after each 0xFF)."""

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.cur)
                if self.cur == 0xFF:
                    self.out.append(0x00)
                self.cur = 0
                self.n = 0

    def flush(self) -> bytes:
        if self.n:
            pad = 8 - self.n
            byte = (self.cur << pad) | ((1 << pad) - 1)  # pad with 1 bits
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
        return bytes(self.out)


def encode_jpeg_dct(img: np.ndarray, precision: int | None = None,
                    quant_table: np.ndarray | None = None,
                    quality: int = 90) -> bytes:
    """Sequential-Huffman DCT JPEG encoder (single component, 1x1).

    The encoder mirror of decode_jpeg_dct for the writer and the
    round-trip tests: SOF0 for 8-bit, SOF1 for 12-bit (the DICOM
    JPEG-Extended 1.2.840.10008.1.2.4.51 process). `quant_table` is a
    64-entry natural-order table; default is the Annex K.1 table scaled
    by libjpeg quality semantics."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2:
        raise ValueError("encoder handles single-component frames")
    rows, cols = img.shape
    if precision is None:
        precision = 8 if int(img.max()) < 256 else 12
    if precision not in (8, 12):
        raise ValueError("precision must be 8 or 12")
    if quant_table is None:
        s = 5000 // max(quality, 1) if quality < 50 else 200 - 2 * quality
        quant_table = np.clip((_JDCT_STD_QT * s + 50) // 100, 1, 255)
        if precision == 12:  # scale roughly with the wider dynamic range
            quant_table = np.clip(quant_table * 4, 1, 32767)
    qt = np.asarray(quant_table, np.int64).reshape(64)

    # forward DCT of level-shifted blocks (edge-replicated to 8x8 grid)
    shift = 1 << (precision - 1)
    ph, pw = -(-rows // 8) * 8, -(-cols // 8) * 8
    padded = np.pad(img.astype(np.float64) - shift,
                    ((0, ph - rows), (0, pw - cols)), mode="edge")
    blocks = padded.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
    b = _jdct_basis()
    coefs = np.einsum("ux,ijxy,vy->ijuv", b, blocks, b)
    q = np.round(coefs / qt.reshape(8, 8)).astype(np.int64)
    zz = q.reshape(-1, 64)[:, _JDCT_ZIGZAG]  # (nblocks, 64) zigzag order

    # gather symbols: DC categories + AC (run, size) pairs
    dc_diffs = np.diff(zz[:, 0], prepend=0)
    ac_syms: set[int] = {0x00}  # EOB always present in the table
    blocks_rle = []
    for row in zz:
        rle = []
        run = 0
        for k in range(1, 64):
            v = int(row[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                rle.append((0xF0, 0))
                ac_syms.add(0xF0)
                run -= 16
            sz = _jdct_category(v)
            sym = (run << 4) | sz
            rle.append((sym, v))
            ac_syms.add(sym)
            run = 0
        if run:
            rle.append((0x00, 0))  # EOB
        blocks_rle.append(rle)

    # fixed-length canonical tables: DC 16 syms @5 bits, AC all @9 bits
    dc_huff = _JdctHuff([(5, t) for t in range(16)])
    ac_huff = _JdctHuff([(9, sym) for sym in sorted(ac_syms)])

    w = _JdctBitWriter()
    for i, rle in enumerate(blocks_rle):
        diff = int(dc_diffs[i])
        t = _jdct_category(diff)
        code, ln = dc_huff.codes[t]
        w.put(code, ln)
        if t:
            w.put(diff if diff >= 0 else diff + (1 << t) - 1, t)
        for sym, v in rle:
            code, ln = ac_huff.codes[sym]
            w.put(code, ln)
            sz = sym & 15
            if sz:
                w.put(v if v >= 0 else v + (1 << sz) - 1, sz)
    scan = w.flush()

    pq = 1 if qt.max() > 255 else 0
    qt_zig = qt[_JDCT_ZIGZAG]
    dqt_body = bytes([pq << 4]) + (
        b"".join(struct.pack(">H", int(v)) for v in qt_zig) if pq
        else bytes(int(v) for v in qt_zig))
    sof_marker = b"\xff\xc0" if precision == 8 else b"\xff\xc1"

    out = bytearray(b"\xff\xd8")
    out += b"\xff\xdb" + struct.pack(">H", 2 + len(dqt_body)) + dqt_body
    sof = bytes([precision]) + struct.pack(">HH", rows, cols) + \
        bytes([1, 1, 0x11, 0])
    out += sof_marker + struct.pack(">H", 2 + len(sof)) + sof
    for tc, huff in ((0, dc_huff), (1, ac_huff)):
        payload = huff.dht_payload(tc, 0)
        out += b"\xff\xc4" + struct.pack(">H", 2 + len(payload)) + payload
    sos = bytes([1, 1, 0x00, 0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    out += scan
    out += b"\xff\xd9"
    return bytes(out)
