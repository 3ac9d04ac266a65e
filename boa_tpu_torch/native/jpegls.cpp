// JPEG-LS (ITU-T T.87 / ISO 14495-1) decoder, single-component scans.
//
// Decodes the JPEG-LS DICOM transfer syntaxes (Lossless
// 1.2.840.10008.1.2.4.80 and Near-Lossless …4.81) that the reference
// reads through SimpleITK/GDCM/CharLS
// (`body_organ_analysis/compute/io.py:326-383`). Implemented from the
// public T.87 specification (LOCO-I: gradient-context modeling, Golomb
// coding with bias cancellation, run mode); no third-party code.
// Exposed via ctypes (boa_tpu/native/__init__.py); the pure-python
// fallback lives in boa_tpu/io/dicom_codecs.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// MSB-first bit reader with JPEG-LS bit-unstuffing: a 0xFF byte is
// followed by a byte carrying only 7 payload bits (its MSB is a stuffed
// 0). 0xFF followed by a byte with MSB set is a marker.
struct LsBitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;
  int bit = 0;          // bits consumed of current byte
  bool prev_ff = false; // current byte follows a 0xFF (7 payload bits)
  bool marker_hit = false;

  LsBitReader(const uint8_t* d, int64_t n) : data(d), len(n) {}

  int next() {
    if (pos >= len) { marker_hit = true; return 0; }
    uint8_t cur = data[pos];
    if (prev_ff && bit == 0 && (cur & 0x80)) { marker_hit = true; return 0; }
    int first = prev_ff ? 1 : 0;  // skip the stuffed MSB
    int b = (cur >> (7 - (bit + first))) & 1;
    if (++bit == 8 - first) {
      bit = 0;
      prev_ff = (cur == 0xFF);
      pos++;
    }
    return b;
  }

  int bits(int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | next();
    return v;
  }
};

const int J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                   4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct LsState {
  int maxval, near, range, qbpp, limit, reset;
  int t1, t2, t3;
  // regular contexts 0..364, run interruption 365 (RItype 0) / 366 (1)
  int32_t A[367], B[365], C[365], N[367], Nn[2];

  void init() {
    int a0 = (range + 32) / 64;
    if (a0 < 2) a0 = 2;
    for (int i = 0; i < 367; i++) { A[i] = a0; N[i] = 1; }
    for (int i = 0; i < 365; i++) { B[i] = 0; C[i] = 0; }
    Nn[0] = Nn[1] = 0;
  }

  int quantize(int d) const {
    if (d <= -t3) return -4;
    if (d <= -t2) return -3;
    if (d <= -t1) return -2;
    if (d < -near) return -1;
    if (d <= near) return 0;
    if (d < t1) return 1;
    if (d < t2) return 2;
    if (d < t3) return 3;
    return 4;
  }

  int fix(int v) const {  // modulo-reduce + clamp a reconstructed sample
    if (v < -near) v += range * (2 * near + 1);
    else if (v > maxval + near) v -= range * (2 * near + 1);
    if (v < 0) v = 0;
    if (v > maxval) v = maxval;
    return v;
  }
};

// Limited-length Golomb decode (T.87 A.5.3 inverse). `lim` is LIMIT for
// regular mode, LIMIT - J[RUNindex] - 1 for run interruption.
inline int golomb_decode(LsBitReader& br, int k, int lim, int qbpp) {
  int u = 0;
  while (br.next() == 0) {
    if (br.marker_hit || ++u > lim) { br.marker_hit = true; return 0; }
  }
  if (u < lim - qbpp - 1) return (u << k) | br.bits(k);
  return br.bits(qbpp) + 1;
}

// thresholds per C.2.4.1.1 (default BASIC_T = 3, 7, 21)
void default_thresholds(LsState& st) {
  const int bt1 = 3, bt2 = 7, bt3 = 21;
  int maxval = st.maxval, near = st.near;
  auto clamp1 = [&](int i) {
    if (i > maxval || i < near + 1) return near + 1;
    return i;
  };
  int t1, t2, t3;
  if (maxval >= 128) {
    int f = (maxval < 4095 ? maxval : 4095);
    f = (f + 128) / 256;
    t1 = clamp1(f * (bt1 - 2) + 2 + 3 * near);
    t2 = f * (bt2 - 3) + 3 + 5 * near;
    t3 = f * (bt3 - 4) + 4 + 7 * near;
  } else {
    int f = 256 / (maxval + 1);
    t1 = bt1 / f;
    if (t1 < 2) t1 = 2;
    t1 = clamp1(t1 + 3 * near);
    t2 = bt2 / f;
    if (t2 < 3) t2 = 3;
    t2 += 5 * near;
    t3 = bt3 / f;
    if (t3 < 4) t3 = 4;
    t3 += 7 * near;
  }
  if (t2 > maxval || t2 < t1) t2 = t1;       // CLAMP_2
  if (t3 > maxval || t3 < t2) t3 = t2;       // CLAMP_3
  st.t1 = t1; st.t2 = t2; st.t3 = t3;
}

int ceil_log2(int v) {
  int b = 0;
  while ((1 << b) < v) b++;
  return b;
}

// decode one scan into out[rows*cols]; returns 0 on success
int decode_scan(LsBitReader& br, LsState& st, uint16_t* out, int rows,
                int cols) {
  st.init();
  std::vector<int32_t> prev(cols + 2, 0), cur(cols + 2, 0);
  int run_index = 0;

  for (int row = 0; row < rows; row++) {
    cur[0] = prev[1];                  // Ra of first sample = Rb
    prev[cols + 1] = prev[cols];       // Rd at right edge duplicates Rb
    int col = 1;
    while (col <= cols) {
      int ra = cur[col - 1], rb = prev[col], rc = prev[col - 1],
          rd = prev[col + 1];
      int q1 = st.quantize(rd - rb), q2 = st.quantize(rb - rc),
          q3 = st.quantize(rc - ra);

      if (q1 == 0 && q2 == 0 && q3 == 0) {
        // ---- run mode (A.7) ----
        int rem = cols - col + 1;
        while (rem > 0) {
          int bitv = br.next();
          if (br.marker_hit) return -10;
          if (bitv == 1) {
            int cnt = 1 << J[run_index];
            if (cnt <= rem) {
              // full 2^J segment
              for (int i = 0; i < cnt; i++) cur[col++] = ra;
              rem -= cnt;
              if (run_index < 31) run_index++;
              if (rem == 0) break;  // run reaches end of line exactly
            } else {
              // final partial segment at end of line (single 1 bit)
              for (int i = 0; i < rem; i++) cur[col++] = ra;
              rem = 0;
              break;
            }
          } else {
            int rcnt = J[run_index] > 0 ? br.bits(J[run_index]) : 0;
            if (br.marker_hit || rcnt > rem - 1) return -11;
            for (int i = 0; i < rcnt; i++) cur[col++] = ra;
            // run interruption sample (A.7.2)
            int rb2 = prev[col], ra2 = cur[col - 1];
            int ritype = (std::abs(ra2 - rb2) <= st.near) ? 1 : 0;
            int px = ritype ? ra2 : rb2;
            int ctx = 365 + ritype;
            int temp = st.A[ctx] + (ritype ? (st.N[ctx] >> 1) : 0);
            int k = 0;
            while ((st.N[ctx] << k) < temp) k++;
            int em = golomb_decode(br, k, st.limit - J[run_index] - 1,
                                   st.qbpp);
            if (br.marker_hit) return -10;
            int tmp2 = em + ritype;
            int map = tmp2 & 1;
            int eabs = (tmp2 + map) / 2;
            int errval =
                (((k != 0 || 2 * st.Nn[ritype] >= st.N[ctx]) ? 1 : 0) == map)
                    ? -eabs
                    : eabs;
            // context update with the unsigned-prediction error
            if (errval < 0) st.Nn[ritype]++;
            st.A[ctx] += (em + 1 - ritype) >> 1;
            if (st.N[ctx] == st.reset) {
              st.A[ctx] >>= 1;
              st.N[ctx] >>= 1;
              st.Nn[ritype] >>= 1;
            }
            st.N[ctx]++;
            int e = errval * (2 * st.near + 1);
            int rx = ritype ? px + e
                            : (rb2 > ra2 ? px + e : px - e);
            cur[col++] = st.fix(rx);
            if (run_index > 0) run_index--;
            break;
          }
        }
        continue;
      }

      // ---- regular mode (A.4-A.6) ----
      int q = q1 * 81 + q2 * 9 + q3;
      int sign = 1;
      if (q < 0) { sign = -1; q = -q; }
      q -= 1;  // contexts 0..364 for |Q| in 1..365... (|Q| max 364+?)
      // |Q| ranges 1..364? Q in [-364, 364] minus 0 -> index 0..363;
      // classic implementations use 365 slots, index = |Q| - 1.
      int px;
      if (rc >= (ra > rb ? ra : rb)) px = ra < rb ? ra : rb;
      else if (rc <= (ra < rb ? ra : rb)) px = ra > rb ? ra : rb;
      else px = ra + rb - rc;
      px += sign * st.C[q];
      if (px < 0) px = 0;
      if (px > st.maxval) px = st.maxval;

      int k = 0;
      while ((st.N[q] << k) < st.A[q]) k++;
      int m = golomb_decode(br, k, st.limit, st.qbpp);
      if (br.marker_hit) return -10;
      int errval = (m & 1) ? -((m >> 1) + 1) : (m >> 1);
      if (k == 0 && st.near == 0 && 2 * st.B[q] <= -st.N[q])
        errval = -errval - 1;  // inverse of the A.5.2 special mapping
      // context update BEFORE applying sign (T.87 A.6)
      st.B[q] += errval * (2 * st.near + 1);
      st.A[q] += std::abs(errval);
      if (st.N[q] == st.reset) {
        st.A[q] >>= 1;
        st.B[q] = st.B[q] >= 0 ? st.B[q] >> 1 : -((1 - st.B[q]) >> 1);
        st.N[q] >>= 1;
      }
      st.N[q]++;
      if (st.B[q] <= -st.N[q]) {
        st.B[q] += st.N[q];
        if (st.C[q] > -128) st.C[q]--;
        if (st.B[q] <= -st.N[q]) st.B[q] = -st.N[q] + 1;
      } else if (st.B[q] > 0) {
        st.B[q] -= st.N[q];
        if (st.C[q] < 127) st.C[q]++;
        if (st.B[q] > 0) st.B[q] = 0;
      }
      int e = errval * (2 * st.near + 1) * sign;
      cur[col++] = st.fix(px + e);
    }
    for (int i = 0; i <= cols + 1; i++) prev[i] = cur[i];
    for (int c2 = 1; c2 <= cols; c2++)
      out[(int64_t)row * cols + (c2 - 1)] = (uint16_t)cur[c2];
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success; negative on parse/stream errors. Output is
// uint16 row-major. Single-component scans only (DICOM CT/MR frames).
int32_t boa_jpegls_decode(const uint8_t* data, int64_t len, uint16_t* out,
                          int64_t out_capacity, int32_t* rows_out,
                          int32_t* cols_out, int32_t* ncomp_out,
                          int32_t* precision_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // no SOI
  int64_t p = 2;
  int precision = 0, rows = 0, cols = 0, ncomp = 0;
  int maxval = -1, t1 = 0, t2 = 0, t3 = 0, reset = 64;
  bool have_lse = false;

  while (p + 2 <= len) {
    if (data[p] != 0xFF) return -2;
    uint8_t m = data[p + 1];
    p += 2;
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xD9) return -4;  // EOI before SOS
    if (p + 2 > len) return -3;
    int seg = (data[p] << 8) | data[p + 1];
    if (seg < 2 || p + seg > len) return -3;
    const uint8_t* s = data + p + 2;
    int slen = seg - 2;

    if (m == 0xF7) {  // SOF55
      // every field below must be covered by the declared segment length
      // (truncated/crafted headers would read past the input buffer)
      if (slen < 6) return -3;
      precision = s[0];
      rows = (s[1] << 8) | s[2];
      cols = (s[3] << 8) | s[4];
      ncomp = s[5];
    } else if (m == 0xF8) {  // LSE
      if (slen < 1) return -3;
      if (s[0] == 1) {
        if (slen < 11) return -3;
        maxval = (s[1] << 8) | s[2];
        t1 = (s[3] << 8) | s[4];
        t2 = (s[5] << 8) | s[6];
        t3 = (s[7] << 8) | s[8];
        reset = (s[9] << 8) | s[10];
        have_lse = true;
      } else {
        return -5;  // mapping tables / extensions unsupported
      }
    } else if (m == 0xDA) {  // SOS
      if (slen < 1) return -3;
      int ns = s[0];
      if (ns != 1 || ncomp != 1) return -6;  // single-component only
      if (slen < 1 + 2 * ns + 3) return -3;
      int near = s[1 + 2 * ns];
      int ilv = s[2 + 2 * ns];
      if (ilv != 0) return -7;
      if ((s[3 + 2 * ns] & 15) != 0) return -12;  // point transform: the
      // decoded samples would need a <<Pt shift this decoder never applies
      if (rows <= 0 || cols <= 0 || precision < 2 || precision > 16)
        return -8;
      if ((int64_t)rows * cols > out_capacity) return -9;

      LsState st;
      st.maxval = maxval > 0 ? maxval : (1 << precision) - 1;  // LSE 0 = default
      st.near = near;
      st.range = (st.maxval + 2 * near) / (2 * near + 1) + 1;
      st.qbpp = ceil_log2(st.range);
      int bpp = ceil_log2(st.maxval + 1);
      if (bpp < 2) bpp = 2;
      st.limit = 2 * (bpp + (bpp < 8 ? 8 : bpp));
      st.reset = reset > 0 ? reset : 64;
      default_thresholds(st);  // defaults first; LSE overrides non-zero
      if (have_lse) {
        if (t1 > 0) st.t1 = t1;
        if (t2 > 0) st.t2 = t2;
        if (t3 > 0) st.t3 = t3;
      }

      LsBitReader br(data + p + seg, len - p - seg);
      int rc = decode_scan(br, st, out, rows, cols);
      if (rc != 0) return rc;
      *rows_out = rows;
      *cols_out = cols;
      *ncomp_out = 1;
      *precision_out = precision;
      return 0;
    }
    p += seg;
  }
  return -3;
}

}  // extern "C"
