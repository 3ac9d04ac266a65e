"""The port's JPEG 2000 decoders against Pillow/OpenJPEG and the reference's,
on the CPU: `boa_tpu_torch/io/j2k.py` (the plain version) and the port's
library (`boa_tpu_torch/native/jpeg2000.cpp`, built with g++ at first use)
on tests/test_j2k.py's twelve Pillow-encoded cases and its edge cases.
Bars: equal to the OpenJPEG decode of the stream and to the reference's
`j2k.decode`, bit for bit (the library as the 16-bit pattern).
"""

import io

import numpy as np
import pytest
from PIL import Image

from boa_tpu.io import j2k as jj
from boa_tpu_torch.io import dicom_codecs as tc
from boa_tpu_torch.io import j2k


def _enc(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG2000", irreversible=False, no_jp2=True, **kw)
    return buf.getvalue()


def _oracle(data: bytes) -> np.ndarray:
    return np.array(Image.open(io.BytesIO(data))).astype(np.int64)


def _u16(a: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) & 0xFFFF).astype(np.uint16)


CASES = {
    "u8-noise": lambda rng: (rng.integers(0, 255, (16, 16)).astype(np.uint8), {}),
    "u8-rect": lambda rng: (rng.integers(0, 255, (24, 17)).astype(np.uint8), {}),
    "u16-grad": lambda rng: ((np.arange(32 * 45).reshape(32, 45) % 4096).astype(np.uint16), {}),
    "u16-noise": lambda rng: (rng.integers(0, 65536, (33, 29)).astype(np.uint16), {}),
    "one-res": lambda rng: (rng.integers(0, 255, (16, 16)).astype(np.uint8),
                            {"num_resolutions": 1}),
    "cb32": lambda rng: (rng.integers(0, 4096, (70, 70)).astype(np.uint16),
                         {"codeblock_size": (32, 32)}),
    "multi-cb": lambda rng: (rng.integers(0, 4096, (200, 150)).astype(np.uint16), {}),
    "ct-like": lambda rng: ((np.clip(rng.normal(40, 120, (96, 96)), -1024, 3071) + 1024)
                            .astype(np.uint16), {}),
    "rpcl": lambda rng: (rng.integers(0, 4096, (80, 64)).astype(np.uint16),
                         {"progression": "RPCL"}),
    "cprl": lambda rng: (rng.integers(0, 4096, (80, 64)).astype(np.uint16),
                         {"progression": "CPRL"}),
    "layers": lambda rng: (rng.integers(0, 4096, (80, 64)).astype(np.uint16),
                           {"quality_mode": "rates", "quality_layers": [40, 10, 1]}),
    "tiles": lambda rng: (rng.integers(0, 4096, (130, 100)).astype(np.uint16),
                          {"tile_size": (64, 64)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoders_match_openjpeg(case):
    """The plain version, the library and the reference's decoder reproduce
    the OpenJPEG decode of the stream (lossless cases: the pixels too)."""
    img, kw = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    data = _enc(img, **kw)
    want = _oracle(data)
    got = j2k.decode(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jj.decode(data))
    np.testing.assert_array_equal(tc._decode_j2k_native(data), _u16(want))
    np.testing.assert_array_equal(tc.decode_jpeg2000(data), _u16(want))
    if case != "tiles":  # openjpeg's encoder is lossy on partial-width tiles
        np.testing.assert_array_equal(got, img.astype(np.int64))


def test_malformed_siz_rejected_not_crash():
    """XTsiz = 0 raises in the plain version and in the library."""
    img = np.random.default_rng(20).integers(0, 255, (16, 16)).astype(np.uint8)
    data = bytearray(_enc(img))
    pos = data.find(b"\xff\x51")
    data[pos + 6 + 16:pos + 6 + 20] = (0).to_bytes(4, "big")
    data = bytes(data)
    with pytest.raises(ValueError):
        j2k.decode(data)
    with pytest.raises(ValueError, match="native J2K decode failed"):
        tc._decode_j2k_native(data)


def test_bitreader_stuffing_is_reader_local():
    br = j2k.BitReader(bytes([0x00, 0xFF, 0b10110010]))
    br.skip_raw(2)
    assert br.bits(8) == 0b10110010
    br2 = j2k.BitReader(bytes([0xFF, 0b01110010]))
    assert br2.bits(8) == 0xFF
    assert br2.bits(7) == 0b1110010


def test_eph_streams_decode_identically():
    """EPH markers after every packet header (Scod bit 2): the plain version
    and the library decode the stream as its EPH-free original."""
    img = np.random.default_rng(21).integers(0, 4096, (40, 33)).astype(np.uint16)
    data = _enc(img)
    siz, cp, tiles = j2k._parse_markers(data)
    assert len(tiles) == 1
    _, tdata = tiles[0]
    res = j2k._build_bands(0, 0, siz["xsiz"], siz["ysiz"], cp.n_levels, cp.cb_w, cp.cb_h)
    br = j2k.BitReader(tdata)
    ends: list[int] = []
    for layer in range(cp.n_layers):
        for r in range(cp.n_levels + 1):
            j2k._decode_packet(br, res[r], layer, cp, [], header_ends=ends)
    new_tile = bytearray(tdata)
    for pos in sorted(ends, reverse=True):
        new_tile[pos:pos] = b"\xff\x92"
    out = bytearray(data)
    cod = out.find(b"\xff\x52")
    out[cod + 4] |= 4
    sot = out.find(b"\xff\x90")
    psot_old = int.from_bytes(out[sot + 6:sot + 10], "big")
    start = out.find(b"\xff\x93", sot) + 2
    out[start:start + len(tdata)] = new_tile
    out[sot + 6:sot + 10] = (psot_old + len(new_tile) - len(tdata)).to_bytes(4, "big")
    out = bytes(out)
    want = j2k.decode(data)
    np.testing.assert_array_equal(j2k.decode(out), want)
    np.testing.assert_array_equal(jj.decode(out), want)
    np.testing.assert_array_equal(tc._decode_j2k_native(out), _u16(want))


def test_rejects_non_codestream():
    with pytest.raises(ValueError, match="SOC"):
        j2k.decode(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="SOC"):
        tc._decode_j2k_native(b"\x00\x01\x02\x03")


def test_rejects_irreversible():
    img = np.random.default_rng(22).integers(0, 255, (16, 16)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG2000", irreversible=True, no_jp2=True)
    with pytest.raises(ValueError, match="5/3"):
        j2k.decode(buf.getvalue())
    with pytest.raises(ValueError, match="native J2K decode failed"):
        tc._decode_j2k_native(buf.getvalue())


def test_signed_component():
    """Signed Ssiz: no DC shift, the two's-complement pattern out; the plain
    version and the library agree."""
    img = np.random.default_rng(23).integers(0, 4096, (32, 24)).astype(np.uint16)
    data = bytearray(_enc(img))
    ssiz_at = data.find(b"\xff\x51") + 4 + 36
    assert data[ssiz_at] == 15
    data[ssiz_at] = 0x80 | 15
    data = bytes(data)
    got_py = j2k.decode(data)
    np.testing.assert_array_equal((got_py + (1 << 15)).astype(np.int64) & 0xFFFF,
                                  img.astype(np.int64))
    np.testing.assert_array_equal(got_py, jj.decode(data))
    np.testing.assert_array_equal(tc._decode_j2k_native(data), _u16(got_py))


def test_library_matches_plain_on_a_ct_frame():
    img = (np.clip(np.random.default_rng(24).normal(40, 120, (128, 96)), -1024, 3071)
           + 1024).astype(np.uint16)
    data = _enc(img)
    np.testing.assert_array_equal(tc._decode_j2k_native(data), _u16(j2k.decode(data)))
