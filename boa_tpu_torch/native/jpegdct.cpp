// JPEG DCT (lossy) decoder: ITU T.81 baseline (SOF0, process 1) and
// extended sequential Huffman (SOF1, process 2&4, 8/12-bit).
//
// Covers the two lossy DICOM transfer syntaxes (JPEG Baseline
// 1.2.840.10008.1.2.4.50 and JPEG Extended 12-bit 1.2.840.10008.1.2.4.51)
// that GDCM decodes for the reference (`compute/io.py:326-383`) and that
// io/dicom.py previously rejected. Sequential Huffman only — progressive
// (SOF2) and arithmetic coding are not legal in these DICOM syntaxes.
//
// Supports up to 4 components with sampling factors 1 or 2 per axis
// (covers monochrome CT/CR and YCbCr 4:4:4 / 4:2:2 / 4:2:0 secondary
// captures); subsampled planes are nearest-upsampled to frame resolution.
// Implemented from the public T.81 spec; no third-party code.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReaderD {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;
  int bit = 0;
  bool marker_hit = false;

  explicit BitReaderD(const uint8_t* d, int64_t n) : data(d), len(n) {}

  int next() {
    if (pos >= len) { marker_hit = true; return 0; }
    uint8_t cur = data[pos];
    if (cur == 0xFF && bit == 0) {
      if (pos + 1 >= len) { marker_hit = true; return 0; }
      if (data[pos + 1] != 0x00) { marker_hit = true; return 0; }
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

  bool sync_restart() {
    if (pos >= len) return false;
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

struct HuffTableD {
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

  int decode(BitReaderD& br) const {
    int code = br.next();
    for (int l = 1; l <= 16; l++) {
      if (maxcode[l] >= 0 && code <= maxcode[l])
        return values[valptr[l] + code - mincode[l]];
      code = (code << 1) | br.next();
    }
    return -1;
  }
};

inline int extend_d(int v, int ssss) {  // T.81 F.2.2.1
  if (ssss == 0) return 0;
  if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
  return v;
}

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// B[u][x] = C(u)/2 * cos((2x+1) u pi / 16); spatial = B^T * F * B
struct Basis {
  double b[8][8];
  Basis() {
    for (int u = 0; u < 8; u++) {
      double cu = (u == 0) ? std::sqrt(0.5) : 1.0;
      for (int x = 0; x < 8; x++)
        b[u][x] = 0.5 * cu * std::cos((2 * x + 1) * u * M_PI / 16.0);
    }
  }
};
const Basis kB;

void idct8x8(const double F[64], double out[64]) {
  double tmp[64];
  for (int u = 0; u < 8; u++)        // tmp = F * B  (rows: u, cols: y)
    for (int y = 0; y < 8; y++) {
      double s = 0;
      for (int v = 0; v < 8; v++) s += F[u * 8 + v] * kB.b[v][y];
      tmp[u * 8 + y] = s;
    }
  for (int x = 0; x < 8; x++)        // out = B^T * tmp
    for (int y = 0; y < 8; y++) {
      double s = 0;
      for (int u = 0; u < 8; u++) s += kB.b[u][x] * tmp[u * 8 + y];
      out[x * 8 + y] = s;
    }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;            // plane size in blocks
  std::vector<double> plane;     // (bh*8) x (bw*8) spatial samples
};

}  // namespace

extern "C" {

// Decode one sequential-Huffman DCT JPEG frame. out (interleaved
// components) must hold rows*cols*ncomp uint16. Returns 0 ok; negative
// error codes otherwise. out == nullptr queries geometry only.
int32_t boa_jpegdct_decode(const uint8_t* data, int64_t len,
                           uint16_t* out, int64_t out_capacity,
                           int32_t* rows_out, int32_t* cols_out,
                           int32_t* ncomp_out, int32_t* precision_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // no SOI
  int64_t p = 2;
  int precision = 0, rows = 0, cols = 0, ncomp = 0;
  Component comps[4];
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  HuffTableD dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  int maxh = 1, maxv = 1;
  bool got_sof = false, decoded_any = false;

  while (p + 2 <= len) {
    if (data[p] != 0xFF) return -2;
    uint8_t m = data[p + 1];
    p += 2;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) break;  // EOI
    if (p + 2 > len) return -3;
    int seg = (data[p] << 8) | data[p + 1];
    if (p + seg > len) return -3;
    const uint8_t* s = data + p + 2;
    int slen = seg - 2;

    if (m == 0xC0 || m == 0xC1) {  // SOF0 baseline / SOF1 extended seq.
      precision = s[0];
      if (precision != 8 && precision != 12) return -4;
      rows = (s[1] << 8) | s[2];
      cols = (s[3] << 8) | s[4];
      ncomp = s[5];
      if (ncomp < 1 || ncomp > 4 || slen < 6 + 3 * ncomp) return -4;
      for (int c = 0; c < ncomp; c++) {
        comps[c].id = s[6 + 3 * c];
        comps[c].h = s[7 + 3 * c] >> 4;
        comps[c].v = s[7 + 3 * c] & 15;
        comps[c].tq = s[8 + 3 * c];
        if (comps[c].h < 1 || comps[c].h > 2 || comps[c].v < 1 ||
            comps[c].v > 2 || comps[c].tq > 3)
          return -5;
        if (comps[c].h > maxh) maxh = comps[c].h;
        if (comps[c].v > maxv) maxv = comps[c].v;
      }
      int mcux = (cols + 8 * maxh - 1) / (8 * maxh);
      int mcuy = (rows + 8 * maxv - 1) / (8 * maxv);
      for (int c = 0; c < ncomp; c++) {
        comps[c].bw = mcux * comps[c].h;
        comps[c].bh = mcuy * comps[c].v;
        comps[c].plane.assign((int64_t)comps[c].bw * comps[c].bh * 64, 0.0);
      }
      got_sof = true;
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      return -6;  // progressive/arithmetic/lossless: not this decoder
    } else if (m == 0xC4) {  // DHT
      int off = 0;
      while (off + 17 <= slen) {
        int tc = s[off] >> 4, th = s[off] & 15;
        const uint8_t* counts = s + off + 1;
        int nv = 0;
        for (int i = 0; i < 16; i++) nv += counts[i];
        if (off + 17 + nv > slen || th > 3 || tc > 1) return -7;
        (tc == 0 ? dc_tables[th] : ac_tables[th]).build(counts,
                                                        s + off + 17, nv);
        off += 17 + nv;
      }
    } else if (m == 0xDB) {  // DQT
      int off = 0;
      while (off < slen) {
        int pq = s[off] >> 4, tq_id = s[off] & 15;
        if (tq_id > 3 || pq > 1) return -8;
        int n = pq ? 128 : 64;
        if (off + 1 + n > slen) return -8;
        for (int i = 0; i < 64; i++)
          qt[tq_id][i] = pq ? (uint16_t)((s[off + 1 + 2 * i] << 8) |
                                         s[off + 2 + 2 * i])
                            : s[off + 1 + i];
        qt_defined[tq_id] = true;
        off += 1 + n;
      }
    } else if (m == 0xDD) {  // DRI
      restart_interval = (s[0] << 8) | s[1];
    } else if (m == 0xDA) {  // SOS
      if (!got_sof) return -9;
      int ns = s[0];
      if (ns < 1 || ns > 4 || slen < 1 + 2 * ns + 3) return -9;
      int scan_comp[4];
      for (int c = 0; c < ns; c++) {
        int cid = s[1 + 2 * c];
        int ci = -1;
        for (int k = 0; k < ncomp; k++)
          if (comps[k].id == cid) ci = k;
        if (ci < 0) return -10;
        scan_comp[c] = ci;
        comps[ci].td = s[2 + 2 * c] >> 4;
        comps[ci].ta = s[2 + 2 * c] & 15;
      }
      // Ss/Se/Ah/Al must be 0/63/0/0 for sequential DCT
      if (s[1 + 2 * ns] != 0 || s[2 + 2 * ns] != 63) return -11;
      p += seg;

      BitReaderD br(data + p, len - p);
      int dcpred[4] = {0, 0, 0, 0};
      int mcu_count = 0;

      // MCU geometry: interleaved uses the frame MCU grid; a single-
      // component scan walks that component's own block grid (T.81 A.2)
      int mcux, mcuy;
      if (ns == 1) {
        const Component& c0 = comps[scan_comp[0]];
        int cw = (cols * c0.h + maxh - 1) / maxh;
        int ch = (rows * c0.v + maxv - 1) / maxv;
        mcux = (cw + 7) / 8;
        mcuy = (ch + 7) / 8;
      } else {
        mcux = (cols + 8 * maxh - 1) / (8 * maxh);
        mcuy = (rows + 8 * maxv - 1) / (8 * maxv);
      }

      for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
          for (int c = 0; c < ns; c++) {
            Component& comp = comps[scan_comp[c]];
            if (!qt_defined[comp.tq]) return -12;
            const HuffTableD& dct = dc_tables[comp.td];
            const HuffTableD& act = ac_tables[comp.ta];
            if (!dct.defined || !act.defined) return -13;
            const uint16_t* q = qt[comp.tq];
            int nbx = (ns == 1) ? 1 : comp.h;
            int nby = (ns == 1) ? 1 : comp.v;
            for (int by = 0; by < nby; by++) {
              for (int bx = 0; bx < nbx; bx++) {
                double F[64] = {0};
                int t = dct.decode(br);
                if (t < 0 || t > 15 || br.marker_hit) return -14;
                int diff = (t == 16) ? 32768 : extend_d(br.bits(t), t);
                dcpred[scan_comp[c]] += diff;
                F[0] = (double)dcpred[scan_comp[c]] * q[0];
                int k = 1;
                while (k < 64) {
                  int rs = act.decode(br);
                  if (rs < 0 || br.marker_hit) return -15;
                  int r = rs >> 4, sz = rs & 15;
                  if (sz == 0) {
                    if (r == 15) { k += 16; continue; }
                    break;  // EOB
                  }
                  k += r;
                  if (k > 63) return -16;
                  F[kZigzag[k]] = (double)extend_d(br.bits(sz), sz) * q[k];
                  k++;
                }
                double sp[64];
                idct8x8(F, sp);
                int blk_x = (ns == 1) ? mx : mx * comp.h + bx;
                int blk_y = (ns == 1) ? my : my * comp.v + by;
                if (blk_x >= comp.bw || blk_y >= comp.bh) return -17;
                double* dst = comp.plane.data() +
                              ((int64_t)blk_y * comp.bw + blk_x) * 64;
                std::memcpy(dst, sp, sizeof(sp));
              }
            }
          }
          if (restart_interval && ++mcu_count == restart_interval) {
            br.sync_restart();
            dcpred[0] = dcpred[1] = dcpred[2] = dcpred[3] = 0;
            mcu_count = 0;
          }
        }
      }
      decoded_any = true;
      // skip to the next marker after the entropy-coded segment
      p += br.pos;
      while (p + 1 < len && !(data[p] == 0xFF && data[p + 1] != 0x00 &&
                              !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
        p++;
      continue;
    }
    p += seg;
  }

  if (!got_sof || !decoded_any) return -18;
  if (rows_out) *rows_out = rows;
  if (cols_out) *cols_out = cols;
  if (ncomp_out) *ncomp_out = ncomp;
  if (precision_out) *precision_out = precision;
  if (!out) return 0;  // geometry query only
  if (out_capacity < (int64_t)rows * cols * ncomp) return -19;

  const int shift = 1 << (precision - 1);
  const int maxval = (1 << precision) - 1;
  for (int c = 0; c < ncomp; c++) {
    const Component& comp = comps[c];
    const int pw = comp.bw * 8;
    for (int y = 0; y < rows; y++) {
      int sy = y * comp.v / maxv;  // nearest upsample of subsampled planes
      for (int x = 0; x < cols; x++) {
        int sx = x * comp.h / maxh;
        const double* blk = comp.plane.data() +
                            ((int64_t)(sy / 8) * comp.bw + (sx / 8)) * 64;
        double v = blk[(sy % 8) * 8 + (sx % 8)];
        int iv = (int)std::lround(v) + shift;
        if (iv < 0) iv = 0;
        if (iv > maxval) iv = maxval;
        out[((int64_t)y * cols + x) * ncomp + c] = (uint16_t)iv;
      }
    }
  }
  return 0;
}

}  // extern "C"
