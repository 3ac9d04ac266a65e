// JPEG lossless (ITU T.81 process 14, SOF3) decoder + DICOM RLE codec.
//
// Decodes the two compressed DICOM transfer syntaxes hospitals actually
// send (JPEG Lossless SV1 1.2.840.10008.1.2.4.70 / .57 and RLE Lossless
// 1.2.840.10008.1.2.5), replacing the reference's GDCM dependency
// (`body_organ_analysis/compute/io.py:326-383` reads series through
// SimpleITK/GDCM). Exposed via ctypes (see boa_tpu/native/__init__.py);
// boa_tpu/io/dicom_codecs.py holds the pure-python fallbacks.
//
// Implemented from the public T.81 spec and the DICOM PS3.5 Annex G
// (RLE) description; no third-party code.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;   // byte position
  int bit = 0;       // bits consumed of current byte
  bool marker_hit = false;

  explicit BitReader(const uint8_t* d, int64_t n) : data(d), len(n) {}

  // next bit, MSB first, with 0xFF00 byte-stuffing; stops at markers
  int next() {
    if (pos >= len) { marker_hit = true; return 0; }
    uint8_t cur = data[pos];
    if (cur == 0xFF && bit == 0) {
      if (pos + 1 >= len) { marker_hit = true; return 0; }
      uint8_t nxt = data[pos + 1];
      if (nxt == 0x00) {
        // stuffed byte: consume bits of the 0xFF, skip the 0x00 after
      } else {
        marker_hit = true;  // real marker (RST/EOI)
        return 0;
      }
    }
    int b = (cur >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      pos += (cur == 0xFF) ? 2 : 1;  // skip stuffing zero byte
    }
    return b;
  }

  int bits(int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | next();
    return v;
  }

  // align to byte boundary and consume an RST marker if present
  bool sync_restart() {
    if (bit != 0) { bit = 0; pos += (data[pos] == 0xFF) ? 2 : 1; }
    if (pos + 1 < len && data[pos] == 0xFF &&
        data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
      pos += 2;
      marker_hit = false;
      return true;
    }
    return false;
  }
};

struct HuffTable {
  // canonical table: min/max code and value offset per length
  int32_t mincode[17], maxcode[17], valptr[17];
  uint8_t values[256];
  bool defined = false;

  void build(const uint8_t counts[16], const uint8_t* vals, int nvals) {
    std::memcpy(values, vals, nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = code - 1;
      if (counts[l - 1] == 0) maxcode[l] = -1;
      code <<= 1;
    }
    defined = true;
  }

  int decode(BitReader& br) const {
    int code = br.next();
    for (int l = 1; l <= 16; l++) {
      if (maxcode[l] >= 0 && code <= maxcode[l])
        return values[valptr[l] + code - mincode[l]];
      code = (code << 1) | br.next();
    }
    return -1;
  }
};

inline int extend(int v, int ssss) {
  // T.81 F.2.2.1 sign extension of the difference magnitude bits
  if (ssss == 0) return 0;
  if (ssss == 16) return 32768;
  if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
  return v;
}

}  // namespace

extern "C" {

// Decode one JPEG-lossless frame. out must hold rows*cols*ncomp uint16.
// Returns 0 ok; negative error codes otherwise. Writes geometry to the
// out-params so callers can pre-query with out == nullptr.
int32_t boa_jpegll_decode(const uint8_t* data, int64_t len,
                          uint16_t* out, int64_t out_capacity,
                          int32_t* rows_out, int32_t* cols_out,
                          int32_t* ncomp_out, int32_t* precision_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // no SOI
  int64_t p = 2;
  int precision = 0, rows = 0, cols = 0, ncomp = 0;
  int comp_id[4] = {0}, comp_dc[4] = {0};
  HuffTable tables[4];
  int restart_interval = 0;
  int predictor = 1, pt = 0;
  int ns = 0;        // components in scan
  int scan_comp[4] = {0};

  while (p + 4 <= len) {
    if (data[p] != 0xFF) return -2;
    uint8_t m = data[p + 1];
    p += 2;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) break;  // EOI before SOS
    if (p + 2 > len) return -3;
    int seg = (data[p] << 8) | data[p + 1];
    if (seg < 2 || p + seg > len) return -3;
    const uint8_t* s = data + p + 2;
    int slen = seg - 2;

    if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {  // SOF3 family
      // every field read below must be covered by the declared segment
      // length (a truncated/crafted SOF would read past the buffer)
      if (slen < 6) return -3;
      precision = s[0];
      rows = (s[1] << 8) | s[2];
      cols = (s[3] << 8) | s[4];
      ncomp = s[5];
      if (ncomp > 4 || ncomp < 1) return -4;
      if (slen < 6 + 3 * ncomp) return -3;
      for (int c = 0; c < ncomp; c++) {
        comp_id[c] = s[6 + 3 * c];
        int hv = s[7 + 3 * c];
        if (hv != 0x11) return -5;  // only 1x1 sampling
      }
    } else if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      return -6;  // a DCT SOF: not lossless
    } else if (m == 0xC4) {  // DHT
      int off = 0;
      while (off + 17 <= slen) {
        int tc = s[off] >> 4, th = s[off] & 15;
        const uint8_t* counts = s + off + 1;
        int nv = 0;
        for (int i = 0; i < 16; i++) nv += counts[i];
        if (off + 17 + nv > slen || th > 3) return -7;
        if (tc == 0) tables[th].build(counts, s + off + 17, nv);
        off += 17 + nv;
      }
    } else if (m == 0xDD) {  // DRI
      if (slen < 2) return -3;
      restart_interval = (s[0] << 8) | s[1];
    } else if (m == 0xDA) {  // SOS — scan follows
      if (slen < 1) return -3;
      ns = s[0];
      if (ns < 1 || ns > 4) return -8;
      if (slen < 1 + 2 * ns + 3) return -3;  // comp specs + Ss/Se/AhAl
      // a scan covering fewer components than the frame would leave the
      // remaining planes of the np.empty output uninitialized
      if (ns != ncomp) return -16;
      for (int c = 0; c < ns; c++) {
        int cid = s[1 + 2 * c];
        int td = s[2 + 2 * c] >> 4;
        int ci = -1;
        for (int k = 0; k < ncomp; k++)
          if (comp_id[k] == cid) ci = k;
        if (ci < 0 || td > 3) return -9;
        scan_comp[c] = ci;
        comp_dc[ci] = td;
      }
      predictor = s[1 + 2 * ns];      // Ss
      pt = s[3 + 2 * ns] & 15;        // Al = point transform
      p += seg;

      if (rows <= 0 || cols <= 0) return -10;
      if (rows_out) *rows_out = rows;
      if (cols_out) *cols_out = cols;
      if (ncomp_out) *ncomp_out = ncomp;
      if (precision_out) *precision_out = precision;
      if (!out) return 0;  // geometry query only
      if (out_capacity < (int64_t)rows * cols * ncomp) return -11;
      if (predictor < 1 || predictor > 7) return -12;

      // ---- decode the (interleaved) scan ----
      BitReader br(data + p, len - p);
      const int default_pred = 1 << (precision - pt - 1);
      const int mask = 0xFFFF;
      int mcu_count = 0;
      // per-component row buffers for Rb/Rc
      std::vector<std::vector<uint16_t>> prev(ns), curr(ns);
      for (int c = 0; c < ns; c++) {
        prev[c].assign(cols, 0);
        curr[c].assign(cols, 0);
      }
      bool fresh = true;  // scan start or just after restart
      int start_row = 0;
      for (int y = 0; y < rows; y++) {
        for (int x = 0; x < cols; x++) {
          for (int c = 0; c < ns; c++) {
            const HuffTable& ht = tables[comp_dc[scan_comp[c]]];
            if (!ht.defined) return -13;
            int ssss = ht.decode(br);
            // a crafted DHT can emit values > 16: the (1 << (ssss-1))
            // shift in extend() would be UB
            if (ssss < 0 || ssss > 16 || br.marker_hit) return -14;
            int diff = (ssss == 16) ? 32768 : extend(br.bits(ssss), ssss);
            int pred;
            if (fresh) {  // scan start / just after restart
              pred = default_pred;
            } else if (y == start_row) {
              pred = curr[c][x - 1];                    // first line: Ra
            } else if (x == 0) {
              pred = prev[c][0];                        // first col: Rb
            } else {
              int ra = curr[c][x - 1], rb = prev[c][x], rc = prev[c][x - 1];
              switch (predictor) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
            }
            uint16_t v = (uint16_t)((pred + diff) & mask);
            curr[c][x] = v;
            out[((int64_t)y * cols + x) * ncomp + scan_comp[c]] =
                (uint16_t)(v << pt);
          }
          fresh = false;
          if (restart_interval && ++mcu_count == restart_interval) {
            if (br.sync_restart()) {
              fresh = true;
              // restart resets prediction to scan-start state: the next
              // sample row behaves like the first line
              start_row = (x == cols - 1) ? y + 1 : y;
            }
            mcu_count = 0;
          }
        }
        for (int c = 0; c < ns; c++) std::swap(prev[c], curr[c]);
      }
      return 0;
    }
    p += seg;
  }
  return -15;  // no SOS found
}

// DICOM RLE (PS3.5 Annex G): PackBits segments with a 64-byte header.
// out must hold rows*cols*nseg bytes laid out as the recomposed samples
// (little-endian composite). Returns 0 ok.
int32_t boa_rle_decode(const uint8_t* data, int64_t len,
                       uint8_t* out, int64_t npix, int32_t bytes_per_sample) {
  if (len < 64) return -1;
  uint32_t nseg;
  std::memcpy(&nseg, data, 4);  // header is little-endian
  if (nseg == 0 || nseg > 15) return -2;
  if ((int32_t)nseg != bytes_per_sample) {
    // multi-sample (RGB) would have samples*bytes segments; caller
    // passes the total expected segment count
    return -2;
  }
  uint32_t offsets[16];
  for (uint32_t i = 0; i < nseg; i++)
    std::memcpy(&offsets[i], data + 4 + 4 * i, 4);
  for (uint32_t seg = 0; seg < nseg; seg++) {
    int64_t sp = offsets[seg];
    int64_t end = (seg + 1 < nseg) ? offsets[seg + 1] : len;
    if (sp < 64 || end > len || sp > end) return -3;
    // segment `seg` holds the MSB-first byte plane: for little-endian
    // composite output, byte index within sample = nseg-1-seg
    int64_t byte_idx = nseg - 1 - seg;
    int64_t outp = 0;
    while (sp < end && outp < npix) {
      int8_t n = (int8_t)data[sp++];
      if (n >= 0) {
        int64_t cnt = (int64_t)n + 1;
        if (sp + cnt > end) cnt = end - sp;
        for (int64_t i = 0; i < cnt && outp < npix; i++)
          out[outp++ * bytes_per_sample + byte_idx] = data[sp + i];
        sp += cnt;
      } else if (n != -128) {
        int64_t cnt = 1 - (int64_t)n;
        if (sp >= end) break;
        uint8_t v = data[sp++];
        for (int64_t i = 0; i < cnt && outp < npix; i++)
          out[outp++ * bytes_per_sample + byte_idx] = v;
      }
    }
    if (outp != npix) return -4;
  }
  return 0;
}

}  // extern "C"
