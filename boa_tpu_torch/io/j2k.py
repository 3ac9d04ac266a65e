"""Pure-Python JPEG 2000 Part-1 decoder (lossless path).

Counterpart of `boa_tpu/io/j2k.py`, and the plain version of the port's
library decoder (`native/jpeg2000.cpp`), which follows this file.
Reference-free reimplementation of the subset DICOM CT/MR frames use
(parity target: the GDCM/OpenJPEG read path of the reference,
`compute/io.py:326-383`): raw J2K codestreams, single component,
reversible 5/3 wavelet, any decomposition depth, 64x64 (or other)
code-blocks, default precincts, LRCP/RLCP/RPCL/PCRL/CPRL progressions,
single quality layer (multi-layer streams decode by accumulating
passes), no coding-style extensions (bypass/reset/termall/vsc raise).

Decoding pipeline: codestream markers (SIZ/COD/QCD/SOT) -> packet
headers (tag trees) -> EBCOT tier-1 (MQ arithmetic decoder, three
passes per bit-plane) -> inverse reversible 5/3 DWT -> DC level shift.

Tests compare both against Pillow/OpenJPEG-encoded oracle streams
(tests/test_torch_j2k.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# MQ arithmetic decoder (ISO 15444-1 Annex C / ITU T.88)
# ---------------------------------------------------------------------------

# (Qe, NMPS, NLPS, SWITCH)
_QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]

# T1 context ids
N_CTX = 19
CTX_UNI = 18
CTX_RL = 17


class MQDecoder:
    """Annex C software-conventions MQ decoder over one byte buffer."""

    __slots__ = ("data", "bp", "c", "a", "ct", "n", "icx", "mps")

    def __init__(self, data: bytes, n_ctx: int = N_CTX) -> None:
        self.data = data
        self.n = len(data)
        self.icx = [0] * n_ctx
        self.mps = [0] * n_ctx
        # INITDEC
        self.bp = 0
        b0 = data[0] if self.n > 0 else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c <<= 7
        self.ct -= 7
        self.a = 0x8000

    def reset_ctx(self) -> None:
        n = len(self.icx)
        self.icx = [0] * n
        self.mps = [0] * n
        self.icx[0] = 4       # ZC context 0
        self.icx[CTX_RL] = 3
        self.icx[CTX_UNI] = 46

    def _bytein(self) -> None:
        d, n, bp = self.data, self.n, self.bp
        if bp < n and d[bp] == 0xFF:
            if bp + 1 >= n or d[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += d[self.bp] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            nb = d[self.bp] if self.bp < n else 0xFF
            if self.bp >= n:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.c += nb << 8
                self.ct = 8

    def decode(self, cx: int) -> int:
        icx = self.icx
        qe, nmps, nlps, switch = _QE[icx[cx]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange or MPS exchange on the lower interval
            if self.a < qe:
                d = self.mps[cx]
                icx[cx] = nmps
            else:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                icx[cx] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                icx[cx] = nlps
            else:
                d = self.mps[cx]
                icx[cx] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.a &= 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# ---------------------------------------------------------------------------
# packet-header bit reader (with 0xFF bit-stuffing) and tag trees
# ---------------------------------------------------------------------------


class BitReader:
    __slots__ = ("data", "pos", "buf", "cnt", "prev_ff")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.buf = 0
        self.cnt = 0
        # bit-stuffing state: True iff the byte THIS READER last consumed
        # was 0xFF. Inspecting raw data[pos-1] instead would mis-trigger
        # after externally skipped bytes (SOP segments, packet bodies)
        # that happen to end in 0xFF.
        self.prev_ff = False

    def bit(self) -> int:
        if self.cnt == 0:
            self.buf = self.data[self.pos]
            self.pos += 1
            self.cnt = 7 if self.prev_ff else 8
            self.prev_ff = self.buf == 0xFF
        self.cnt -= 1
        return (self.buf >> self.cnt) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        """End of packet header: skip to byte boundary (plus the stuffing
        byte if the last consumed byte was 0xFF)."""
        self.cnt = 0
        if self.prev_ff:
            self.pos += 1
        self.prev_ff = False

    def skip_raw(self, n: int) -> None:
        """Advance over non-header bytes (SOP segments, packet bodies);
        resets the stuffing state."""
        self.pos += n
        self.prev_ff = False


class TagTree:
    def __init__(self, w: int, h: int) -> None:
        self.w, self.h = w, h
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w == 1 and h == 1:
                break
            w = (w + 1) // 2
            h = (h + 1) // 2
        self.levels.reverse()  # root first
        self.value = [np.zeros((lh, lw), np.int32) for lw, lh in self.levels]
        self.state = [np.zeros((lh, lw), np.int32) for lw, lh in self.levels]

    def decode(self, br: BitReader, x: int, y: int, threshold: int) -> int:
        """Decode node (x, y) against `threshold`; returns its value if
        < threshold else a value >= threshold (partial knowledge)."""
        lo = 0
        nl = len(self.levels)
        for li in range(nl):
            shift = nl - 1 - li
            xi, yi = x >> shift, y >> shift
            st, va = self.state[li], self.value[li]
            if st[yi, xi] < lo:
                st[yi, xi] = lo
                va[yi, xi] = max(va[yi, xi], lo)
            while st[yi, xi] < threshold and va[yi, xi] == st[yi, xi]:
                if br.bit():
                    va[yi, xi] = st[yi, xi]  # value resolved at state
                    st[yi, xi] += 1
                    break
                st[yi, xi] += 1
                va[yi, xi] = st[yi, xi]
            # clamp: once resolved, state saturates
            lo = min(st[yi, xi], va[yi, xi])
        return self.value[nl - 1][y, x]


# ---------------------------------------------------------------------------
# codestream structures
# ---------------------------------------------------------------------------


@dataclass
class CodingParams:
    n_levels: int = 5
    cb_w: int = 64
    cb_h: int = 64
    cblk_style: int = 0
    transform: int = 1            # 1 = reversible 5/3
    prog_order: int = 0           # 0 LRCP 1 RLCP 2 RPCL 3 PCRL 4 CPRL
    n_layers: int = 1
    precinct_sizes: list = field(default_factory=list)  # (PPx, PPy)/res
    sop: bool = False
    eph: bool = False
    guard_bits: int = 2
    band_exps: list = field(default_factory=list)  # LL, then HL,LH,HH per level


@dataclass
class CodeBlock:
    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    n_zero_bitplanes: int = 0
    lblock: int = 3


@dataclass
class Band:
    orient: int                   # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    cblks: list = field(default_factory=list)   # grid rows of CodeBlock
    inc_tree: object = None
    zbp_tree: object = None
    n_cb_x: int = 0
    n_cb_y: int = 0


def _parse_markers(data: bytes):
    """Parse main header; returns (siz, cp, tiles) where tiles is a list
    of (tile_index, bytes) bitstream segments."""
    if data[:2] != b"\xff\x4f":
        raise ValueError("not a raw J2K codestream (missing SOC)")
    pos = 2
    siz = None
    cp = CodingParams()
    tiles = []
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"marker expected at {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:        # EOC
            break
        if marker == 0x93:        # SOD (shouldn't get here directly)
            raise ValueError("SOD before SOT")
        ln = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + ln]
        if marker == 0x51:        # SIZ
            xsiz = int.from_bytes(seg[2:6], "big")
            ysiz = int.from_bytes(seg[6:10], "big")
            xosiz = int.from_bytes(seg[10:14], "big")
            yosiz = int.from_bytes(seg[14:18], "big")
            xtsiz = int.from_bytes(seg[18:22], "big")
            ytsiz = int.from_bytes(seg[22:26], "big")
            xtosiz = int.from_bytes(seg[26:30], "big")
            ytosiz = int.from_bytes(seg[30:34], "big")
            csiz = int.from_bytes(seg[34:36], "big")
            if csiz != 1:
                raise ValueError(f"only single-component J2K supported "
                                 f"(Csiz={csiz})")
            ssiz = seg[36]
            xr, yr = seg[37], seg[38]
            if xr != 1 or yr != 1:
                raise ValueError("subsampled components unsupported")
            if xtsiz <= 0 or ytsiz <= 0 or xsiz <= xosiz or ysiz <= yosiz \
                    or xtosiz > xosiz or ytosiz > yosiz:
                raise ValueError("malformed SIZ geometry")
            siz = {"xsiz": xsiz, "ysiz": ysiz, "xosiz": xosiz,
                   "yosiz": yosiz, "xtsiz": xtsiz, "ytsiz": ytsiz,
                   "xtosiz": xtosiz, "ytosiz": ytosiz,
                   "prec": (ssiz & 0x7F) + 1, "signed": bool(ssiz & 0x80)}
        elif marker == 0x52:      # COD
            scod = seg[0]
            cp.sop = bool(scod & 2)
            cp.eph = bool(scod & 4)
            cp.prog_order = seg[1]
            cp.n_layers = int.from_bytes(seg[2:4], "big")
            mct = seg[4]
            if mct != 0:
                raise ValueError("MCT unsupported for single component")
            cp.n_levels = seg[5]
            cp.cb_w = 1 << ((seg[6] & 0x0F) + 2)
            cp.cb_h = 1 << ((seg[7] & 0x0F) + 2)
            cp.cblk_style = seg[8]
            if cp.cblk_style not in (0, 0x20):  # allow segsym
                raise ValueError(
                    f"code-block style 0x{cp.cblk_style:02x} unsupported "
                    f"(bypass/reset/termall/vsc)")
            cp.transform = seg[9]
            if cp.transform != 1:
                raise ValueError("only the reversible 5/3 transform is "
                                 "supported (lossless)")
            if scod & 1:          # user precincts
                cp.precinct_sizes = [(b & 0x0F, b >> 4) for b in seg[10:]]
                if any(p != (15, 15) for p in cp.precinct_sizes):
                    raise ValueError(
                        "precinct-partitioned codestreams unsupported")
            else:
                cp.precinct_sizes = [(15, 15)] * (cp.n_levels + 1)
        elif marker == 0x5C:      # QCD — reversible: exponents only
            sqcd = seg[0]
            if (sqcd & 0x1F) != 0:
                raise ValueError("only no-quantization (reversible) QCD "
                                 "supported")
            cp.guard_bits = sqcd >> 5
            cp.band_exps = [b >> 3 for b in seg[1:]]
        elif marker == 0x90:      # SOT
            isot = int.from_bytes(seg[0:2], "big")
            psot = int.from_bytes(seg[2:6], "big")
            tpsot, tnsot = seg[6], seg[7]
            if tpsot != 0 or (tnsot not in (0, 1)):
                raise ValueError("multiple tile-parts unsupported")
            # tile-part header markers until SOD (PLT/COM skippable)
            p2 = pos + ln
            while data[p2:p2 + 2] != b"\xff\x93":
                if p2 + 4 > n or data[p2] != 0xFF:
                    raise ValueError("malformed tile-part header")
                m2 = data[p2 + 1]
                if m2 == 0x61:
                    raise ValueError(
                        "PPT packed packet headers unsupported")
                if m2 not in (0x58, 0x64):  # PLT / COM
                    raise ValueError(
                        f"unsupported tile-header marker 0x{m2:02x}")
                p2 += 2 + int.from_bytes(data[p2 + 2:p2 + 4], "big")
            start = p2 + 2
            end = pos - 2 + (psot if psot else (n - (pos - 2)))
            tiles.append((isot, data[start:end]))
            pos = end
            continue
        elif marker in (0x53, 0x5D):  # COC / QCC
            raise ValueError("per-component COC/QCC unsupported")
        elif marker in (0x60, 0x61):  # PPM/PPT move packet headers
            raise ValueError("PPM/PPT packed packet headers unsupported")
        elif marker == 0x64 or marker == 0x55 or marker == 0x57 \
                or marker == 0x58 or marker == 0x63:
            pass                  # COM/TLM/PLM/PLT/CRG: skip
        elif marker == 0x5F:      # POC
            raise ValueError("POC progression changes unsupported")
        pos += ln
    if siz is None:
        raise ValueError("missing SIZ")
    return siz, cp, tiles


# ---------------------------------------------------------------------------
# tier-1 (EBCOT) code-block decoder
# ---------------------------------------------------------------------------

# zero-coding context tables
def _zc_context(orient: int, h: int, v: int, d: int) -> int:
    if orient == 3:  # HH: diagonal-driven
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else (4 if hv == 1 else 3)
        return 2 if hv >= 2 else (1 if hv == 1 else 0)
    if orient == 1:  # HL: swap h/v
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        if v >= 1:
            return 7
        return 6 if d >= 1 else 5
    if v == 2:
        return 4
    if v == 1:
        return 3
    return 2 if d >= 2 else (1 if d == 1 else 0)


_SC_TABLE = {
    (1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
    (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
    (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1),
}


def _decode_cblk(mq: MQDecoder, w: int, h: int, orient: int,
                 n_bitplanes: int, n_passes: int, segsym: bool
                 ) -> np.ndarray:
    """Decode one code-block; returns int32 signed coefficients."""
    sig = np.zeros((h + 2, w + 2), np.uint8)      # significance (padded)
    sgn = np.zeros((h + 2, w + 2), np.int8)       # sign (-1/+1)
    visited = np.zeros((h, w), np.uint8)
    refined = np.zeros((h, w), np.uint8)
    mag = np.zeros((h, w), np.int32)

    def neighborhood(y: int, x: int):
        yy, xx = y + 1, x + 1
        hsum = sig[yy, xx - 1] + sig[yy, xx + 1]
        vsum = sig[yy - 1, xx] + sig[yy + 1, xx]
        dsum = (sig[yy - 1, xx - 1] + sig[yy - 1, xx + 1]
                + sig[yy + 1, xx - 1] + sig[yy + 1, xx + 1])
        return int(hsum), int(vsum), int(dsum)

    def decode_sign(y: int, x: int) -> int:
        yy, xx = y + 1, x + 1
        hc = int(sig[yy, xx - 1]) * int(sgn[yy, xx - 1]) \
            + int(sig[yy, xx + 1]) * int(sgn[yy, xx + 1])
        vc = int(sig[yy - 1, xx]) * int(sgn[yy - 1, xx]) \
            + int(sig[yy + 1, xx]) * int(sgn[yy + 1, xx])
        hc = max(-1, min(1, hc))
        vc = max(-1, min(1, vc))
        cx, xorbit = _SC_TABLE[(hc, vc)]
        return (mq.decode(cx) ^ xorbit)            # 0 = +, 1 = -

    def set_sig(y: int, x: int, negative: int) -> None:
        sig[y + 1, x + 1] = 1
        sgn[y + 1, x + 1] = -1 if negative else 1

    pass_idx = 0
    bp = n_bitplanes - 1
    while pass_idx < n_passes and bp >= 0:
        pass_kind = 0 if pass_idx == 0 else (pass_idx - 1) % 3
        # first pass of a block is always a cleanup pass at the top plane
        if pass_idx == 0:
            pass_kind = 2

        if pass_kind == 0:       # significance propagation
            visited[:] = 0
            for y0 in range(0, h, 4):
                for x in range(w):
                    for y in range(y0, min(y0 + 4, h)):
                        if sig[y + 1, x + 1]:
                            continue
                        hs, vs, ds = neighborhood(y, x)
                        if hs + vs + ds == 0:
                            continue
                        visited[y, x] = 1
                        if mq.decode(_zc_context(orient, hs, vs, ds)):
                            neg = decode_sign(y, x)
                            set_sig(y, x, neg)
                            mag[y, x] |= 1 << bp
        elif pass_kind == 1:     # magnitude refinement
            for y0 in range(0, h, 4):
                for x in range(w):
                    for y in range(y0, min(y0 + 4, h)):
                        if not sig[y + 1, x + 1] or visited[y, x]:
                            continue
                        if refined[y, x]:
                            cx = 16
                        else:
                            hs, vs, ds = neighborhood(y, x)
                            cx = 15 if (hs + vs + ds) else 14
                            refined[y, x] = 1
                        if mq.decode(cx):
                            mag[y, x] |= 1 << bp
        else:                    # cleanup
            for y0 in range(0, h, 4):
                for x in range(w):
                    y = y0
                    stripe_h = min(4, h - y0)
                    # run-length mode: full stripe, all ctx zero, none
                    # visited
                    if stripe_h == 4:
                        all_clear = True
                        for yy in range(y0, y0 + 4):
                            if visited[yy, x] or sig[yy + 1, x + 1]:
                                all_clear = False
                                break
                            hs, vs, ds = neighborhood(yy, x)
                            if hs + vs + ds:
                                all_clear = False
                                break
                        if all_clear:
                            if mq.decode(CTX_RL) == 0:
                                continue
                            r = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI)
                            y = y0 + r
                            neg = decode_sign(y, x)
                            set_sig(y, x, neg)
                            mag[y, x] |= 1 << bp
                            y += 1
                    for yy in range(y, y0 + stripe_h):
                        if visited[yy, x] or sig[yy + 1, x + 1]:
                            continue
                        hs, vs, ds = neighborhood(yy, x)
                        if mq.decode(_zc_context(orient, hs, vs, ds)):
                            neg = decode_sign(yy, x)
                            set_sig(yy, x, neg)
                            mag[yy, x] |= 1 << bp
            if segsym:
                v = 0
                for _ in range(4):
                    v = (v << 1) | mq.decode(CTX_UNI)
                # segmentation symbol must be 1010; tolerate mismatch
            bp -= 1
        pass_idx += 1

    out = mag.astype(np.int32)
    neg = sgn[1:h + 1, 1:w + 1] < 0
    out[neg] = -out[neg]
    return out


# ---------------------------------------------------------------------------
# packets + tiles
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _build_bands(tx0, ty0, tx1, ty1, n_levels, cb_w, cb_h):
    """Per-resolution band geometry for one tile; returns
    bands[r] = list of Band. Resolution r has scale 2^(n_levels - r)."""
    res = []
    for r in range(n_levels + 1):
        nb = n_levels - r
        bands = []
        if r == 0:
            bx0 = _ceil_div(tx0, 1 << nb)
            by0 = _ceil_div(ty0, 1 << nb)
            bx1 = _ceil_div(tx1, 1 << nb)
            by1 = _ceil_div(ty1, 1 << nb)
            bands.append(Band(0, bx0, by0, bx1, by1))
        else:
            sh = nb + 1
            for orient in (1, 2, 3):
                xo = 1 if orient in (1, 3) else 0
                yo = 1 if orient in (2, 3) else 0
                bx0 = _ceil_div(tx0 - (1 << (sh - 1)) * xo, 1 << sh)
                by0 = _ceil_div(ty0 - (1 << (sh - 1)) * yo, 1 << sh)
                bx1 = _ceil_div(tx1 - (1 << (sh - 1)) * xo, 1 << sh)
                by1 = _ceil_div(ty1 - (1 << (sh - 1)) * yo, 1 << sh)
                bands.append(Band(orient, bx0, by0, bx1, by1))
        for band in bands:
            bw, bh = band.x1 - band.x0, band.y1 - band.y0
            if bw <= 0 or bh <= 0:
                band.n_cb_x = band.n_cb_y = 0
                band.cblks = []
                continue
            cbx0 = band.x0 // cb_w
            cby0 = band.y0 // cb_h
            cbx1 = _ceil_div(band.x1, cb_w)
            cby1 = _ceil_div(band.y1, cb_h)
            band.n_cb_x = cbx1 - cbx0
            band.n_cb_y = cby1 - cby0
            band.cblks = [
                [CodeBlock(max(band.x0, (cbx0 + i) * cb_w),
                           max(band.y0, (cby0 + j) * cb_h),
                           min(band.x1, (cbx0 + i + 1) * cb_w),
                           min(band.y1, (cby0 + j + 1) * cb_h))
                 for i in range(band.n_cb_x)]
                for j in range(band.n_cb_y)]
            band.inc_tree = TagTree(band.n_cb_x, band.n_cb_y)
            band.zbp_tree = TagTree(band.n_cb_x, band.n_cb_y)
        res.append(bands)
    return res


def _n_passes_decode(br: BitReader) -> int:
    if br.bit() == 0:
        return 1
    if br.bit() == 0:
        return 2
    v = br.bits(2)
    if v < 3:
        return 3 + v
    v = br.bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.bits(7)


def _decode_packet(br: BitReader, bands, layer: int, cp: CodingParams,
                   contribs: list,
                   header_ends: list | None = None) -> None:
    """One packet (single precinct spanning the whole resolution):
    updates code-block states and appends (cblk, n_passes, data-slice)
    descriptors to consume after the header. `header_ends` (tests)
    records the byte offset where each packet header ends — the EPH
    insertion point."""

    def eph() -> None:
        # EPH terminates the packet HEADER — it sits BEFORE the bodies
        if header_ends is not None:
            header_ends.append(br.pos)
        if cp.eph and br.data[br.pos:br.pos + 2] == b"\xff\x92":
            br.skip_raw(2)

    if br.bit() == 0:            # empty packet
        br.align()
        eph()
        return
    blocks = []
    for band in bands:
        if band.n_cb_x == 0:
            continue
        for j in range(band.n_cb_y):
            for i in range(band.n_cb_x):
                cblk = band.cblks[j][i]
                if not cblk.included:
                    incl = band.inc_tree.decode(br, i, j, layer + 1) <= layer
                else:
                    incl = bool(br.bit())
                if not incl:
                    continue
                if not cblk.included:
                    cblk.included = True
                    k = 1
                    while band.zbp_tree.decode(br, i, j, k) >= k:
                        k += 1
                    cblk.n_zero_bitplanes = k - 1
                n_passes = _n_passes_decode(br)
                while br.bit():
                    cblk.lblock += 1
                # single codeword segment (no bypass/termall)
                bits = cblk.lblock + _int_log2(n_passes)
                blocks.append((band, cblk, n_passes, br.bits(bits)))
    br.align()
    eph()
    for band, cblk, n_passes, ln in blocks:
        contribs.append((band, cblk, n_passes,
                         br.data[br.pos:br.pos + ln]))
        br.skip_raw(ln)


def _int_log2(v: int) -> int:
    r = 0
    while (1 << (r + 1)) <= v:
        r += 1
    return r


def decode(data: bytes) -> np.ndarray:
    """Decode a raw lossless J2K codestream to (rows, cols) int32."""
    siz, cp, tiles = _parse_markers(bytes(data))
    W = siz["xsiz"] - siz["xosiz"]
    H = siz["ysiz"] - siz["yosiz"]
    out = np.zeros((H, W), np.int32)
    n_tx = _ceil_div(siz["xsiz"] - siz["xtosiz"], siz["xtsiz"])

    for isot, tdata in tiles:
        ti, tj = isot % n_tx, isot // n_tx
        tx0 = max(siz["xtosiz"] + ti * siz["xtsiz"], siz["xosiz"])
        ty0 = max(siz["ytosiz"] + tj * siz["ytsiz"], siz["yosiz"])
        tx1 = min(siz["xtosiz"] + (ti + 1) * siz["xtsiz"], siz["xsiz"])
        ty1 = min(siz["ytosiz"] + (tj + 1) * siz["ytsiz"], siz["ysiz"])
        tile = _decode_tile(tdata, cp, tx0, ty0, tx1, ty1)
        out[ty0 - siz["yosiz"]:ty1 - siz["yosiz"],
            tx0 - siz["xosiz"]:tx1 - siz["xosiz"]] = tile

    if not siz["signed"]:
        out += 1 << (siz["prec"] - 1)
    return out


def _decode_tile(tdata: bytes, cp: CodingParams, tx0, ty0, tx1, ty1
                 ) -> np.ndarray:
    res = _build_bands(tx0, ty0, tx1, ty1, cp.n_levels, cp.cb_w, cp.cb_h)
    br = BitReader(tdata)
    contribs: list = []

    def packet(r: int, layer: int) -> None:
        if cp.sop:
            if br.data[br.pos:br.pos + 2] == b"\xff\x91":
                br.skip_raw(6)
        _decode_packet(br, res[r], layer, cp, contribs)

    order = cp.prog_order
    if order == 0:               # LRCP
        for layer in range(cp.n_layers):
            for r in range(cp.n_levels + 1):
                packet(r, layer)
    elif order in (1, 2):        # RLCP / RPCL (single precinct+comp)
        for r in range(cp.n_levels + 1):
            for layer in range(cp.n_layers):
                packet(r, layer)
    elif order in (3, 4):        # PCRL / CPRL: single precinct/component
        for r in range(cp.n_levels + 1):
            for layer in range(cp.n_layers):
                packet(r, layer)
    else:
        raise ValueError(f"progression order {order} unsupported")

    # band index into QCD exponent list (LL, then HL/LH/HH per level)
    def band_exp(r: int, orient: int) -> int:
        idx = 0 if r == 0 else 1 + 3 * (r - 1) + (orient - 1)
        if idx < len(cp.band_exps):
            return cp.band_exps[idx]
        return 8 + (1 if orient == 3 else 0)  # sane default

    band_res = {}
    for r, bands in enumerate(res):
        for band in bands:
            band_res[id(band)] = r

    # tier-1 decode each included code-block
    for band, cblk, n_passes, cdata in _group_contribs(contribs):
        w, h = cblk.x1 - cblk.x0, cblk.y1 - cblk.y0
        if w <= 0 or h <= 0 or not cdata:
            continue
        mq = MQDecoder(cdata)
        mq.reset_ctx()
        # Mb = guard + eps_b - 1 (Annex E, reversible)
        mb = cp.guard_bits + band_exp(band_res[id(band)], band.orient) - 1
        n_bp = mb - cblk.n_zero_bitplanes
        coeffs = _decode_cblk(mq, w, h, band.orient, n_bp, n_passes,
                              segsym=bool(cp.cblk_style & 0x20))
        band.decoded = getattr(band, "decoded", None)
        if band.decoded is None:
            band.decoded = np.zeros((band.y1 - band.y0, band.x1 - band.x0),
                                    np.int32)
        band.decoded[cblk.y0 - band.y0:cblk.y1 - band.y0,
                     cblk.x0 - band.x0:cblk.x1 - band.x0] = coeffs

    # assemble subband pyramid and run the inverse 5/3 DWT
    return _inverse_dwt(res, cp, tx0, ty0, tx1, ty1)


def _group_contribs(contribs):
    """Merge multi-layer contributions per code-block (passes accumulate,
    bitstreams concatenate)."""
    merged: dict = {}
    order = []
    for band, cblk, n_passes, data in contribs:
        key = id(cblk)
        if key not in merged:
            merged[key] = [band, cblk, 0, b""]
            order.append(key)
        merged[key][2] += n_passes
        merged[key][3] += data
    return [tuple(merged[k]) for k in order]


def _inverse_dwt(res, cp: CodingParams, tx0, ty0, tx1, ty1) -> np.ndarray:
    ll = _band_array(res[0][0])
    for r in range(1, cp.n_levels + 1):
        hl = _band_array(res[r][0])
        lh = _band_array(res[r][1])
        hh = _band_array(res[r][2])
        nb = cp.n_levels - r
        ux0, uy0 = _ceil_div(tx0, 1 << nb), _ceil_div(ty0, 1 << nb)
        ux1, uy1 = _ceil_div(tx1, 1 << nb), _ceil_div(ty1, 1 << nb)
        ll = _idwt53(ll, hl, lh, hh, ux0, uy0, ux1, uy1)
    return ll


def _band_array(band: Band) -> np.ndarray:
    arr = getattr(band, "decoded", None)
    if arr is None:
        arr = np.zeros((max(band.y1 - band.y0, 0),
                        max(band.x1 - band.x0, 0)), np.int32)
    return arr


def _idwt53(ll, hl, lh, hh, ux0, uy0, ux1, uy1) -> np.ndarray:
    """One inverse reversible 5/3 level. The output occupies
    [uy0:uy1) x [ux0:ux1) in resolution coordinates; even indices are
    lowpass samples."""
    w, h = ux1 - ux0, uy1 - uy0
    out = np.zeros((h, w), np.int64)
    # place subbands on the interleaved lattice: even absolute
    # coordinates hold lowpass samples
    ex, ey = ux0 % 2, uy0 % 2
    ll64 = ll.astype(np.int64)
    hl64 = hl.astype(np.int64)
    lh64 = lh.astype(np.int64)
    hh64 = hh.astype(np.int64)
    ystart_l = (0 - ey) % 2   # local row index of first even abs row
    xstart_l = (0 - ex) % 2
    out[ystart_l::2, xstart_l::2] = ll64
    out[ystart_l::2, 1 - xstart_l::2] = hl64
    out[1 - ystart_l::2, xstart_l::2] = lh64
    out[1 - ystart_l::2, 1 - xstart_l::2] = hh64

    _lift53_axis(out, ux0, axis=1)
    _lift53_axis(out, uy0, axis=0)
    return out.astype(np.int32)


def _lift53_axis(a: np.ndarray, origin: int, axis: int) -> None:
    """In-place inverse 5/3 lifting along `axis` with absolute-coordinate
    parity `origin` (Annex F, with symmetric extension)."""
    n = a.shape[axis]
    if n <= 1:
        if n == 1 and origin % 2 == 1:
            # single high-pass sample: x = h/2 per spec F.3.7 (odd-length
            # degenerate case)
            sl = [slice(None)] * a.ndim
            sl[axis] = 0
            a[tuple(sl)] //= 2
        return
    full = np.moveaxis(a, axis, 0)
    # absolute indices origin..origin+n-1; even = L
    # symmetric extension indices helper
    def at(i: int):
        i = abs(i)
        if i >= n:
            i = 2 * (n - 1) - i
        return full[i]

    # inverse: first even samples x[2k] = L[k] - floor((x[2k-1]+x[2k+1]+2)/4)
    # then odd x[2k+1] = H[k] + floor((x[2k]+x[2k+2])/2)
    # work on absolute parity: local index i is absolute origin+i
    even_local = [i for i in range(n) if (origin + i) % 2 == 0]
    odd_local = [i for i in range(n) if (origin + i) % 2 == 1]
    # step 1 uses neighbor odd (high) values
    upd = {}
    for i in even_local:
        left = at(i - 1)
        right = at(i + 1)
        upd[i] = full[i] - ((left + right + 2) >> 2)
    for i, v in upd.items():
        full[i] = v
    upd = {}
    for i in odd_local:
        left = at(i - 1)
        right = at(i + 1)
        upd[i] = full[i] + ((left + right) >> 1)
    for i, v in upd.items():
        full[i] = v
