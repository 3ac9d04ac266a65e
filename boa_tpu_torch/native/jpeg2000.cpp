// JPEG 2000 Part-1 lossless decoder (native port of boa_tpu/io/j2k.py).
//
// Scope: raw J2K codestreams as found in DICOM .4.90 frames — single
// component, reversible 5/3 wavelet, default precincts, any progression
// order, multi-layer, multi-tile. Differential-tested against the
// Python reference and Pillow/OpenJPEG (tests/test_j2k.py).
//
// Entry point:
//   boa_j2k_decode(data, len, out_u16, out_cap, &rows, &cols) -> 0 ok

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- MQ coder

struct QeRow { uint16_t qe; uint8_t nmps, nlps, sw; };
static const QeRow QE[47] = {
    {0x5601, 1, 1, 1},  {0x3401, 2, 6, 0},  {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0}, {0x0521, 5, 29, 0}, {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},  {0x5401, 8, 14, 0}, {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0},{0x3001, 11, 17, 0},{0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0},{0x1601, 29, 21, 0},{0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0},{0x5101, 17, 15, 0},{0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0},{0x3401, 20, 18, 0},{0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0},{0x2401, 23, 20, 0},{0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0},{0x1801, 26, 23, 0},{0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0},{0x1201, 29, 26, 0},{0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0},{0x09C1, 32, 29, 0},{0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0},{0x0441, 35, 32, 0},{0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0},{0x0141, 38, 35, 0},{0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0},{0x0049, 41, 38, 0},{0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0},{0x0009, 44, 41, 0},{0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0},{0x5601, 46, 46, 0},
};

constexpr int N_CTX = 19;
constexpr int CTX_RL = 17;
constexpr int CTX_UNI = 18;

struct MQDecoder {
  const uint8_t* data;
  int64_t n, bp;
  uint32_t c, a;
  int32_t ct;
  uint8_t icx[N_CTX];
  uint8_t mps[N_CTX];

  MQDecoder(const uint8_t* d, int64_t len) : data(d), n(len) {
    std::memset(icx, 0, sizeof(icx));
    std::memset(mps, 0, sizeof(mps));
    icx[0] = 4; icx[CTX_RL] = 3; icx[CTX_UNI] = 46;
    bp = 0;
    uint32_t b0 = n > 0 ? data[0] : 0xFF;
    c = b0 << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  void bytein() {
    if (bp < n && data[bp] == 0xFF) {
      if (bp + 1 >= n || data[bp + 1] > 0x8F) {
        c += 0xFF00; ct = 8;
      } else {
        bp += 1; c += (uint32_t)data[bp] << 9; ct = 7;
      }
    } else {
      bp += 1;
      if (bp >= n) { c += 0xFF00; ct = 8; }
      else { c += (uint32_t)data[bp] << 8; ct = 8; }
    }
  }

  int decode(int cx) {
    const QeRow& row = QE[icx[cx]];
    uint32_t qe = row.qe;
    int d;
    a -= qe;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) { d = mps[cx]; icx[cx] = row.nmps; }
      else {
        d = 1 - mps[cx];
        if (row.sw) mps[cx] = 1 - mps[cx];
        icx[cx] = row.nlps;
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        d = 1 - mps[cx];
        if (row.sw) mps[cx] = 1 - mps[cx];
        icx[cx] = row.nlps;
      } else { d = mps[cx]; icx[cx] = row.nmps; }
    }
    do {                        // RENORMD
      if (ct == 0) bytein();
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      ct -= 1;
    } while (!(a & 0x8000));
    return d;
  }
};

// ------------------------------------------------------- packet bit reader

struct BitReader {
  const uint8_t* data;
  int64_t n, pos;
  uint32_t buf;
  int cnt;
  // stuffing state: true iff the byte THIS reader last consumed was
  // 0xFF (raw data[pos-1] would mis-trigger after externally skipped
  // SOP segments / packet bodies ending in 0xFF)
  bool prev_ff = false;
  BitReader(const uint8_t* d, int64_t len) : data(d), n(len), pos(0),
                                             buf(0), cnt(0) {}
  int bit() {
    if (cnt == 0) {
      if (pos >= n) throw std::runtime_error("packet header overrun");
      buf = data[pos++];
      cnt = prev_ff ? 7 : 8;
      prev_ff = buf == 0xFF;
    }
    cnt -= 1;
    return (buf >> cnt) & 1;
  }
  uint32_t bits(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = (v << 1) | bit();
    return v;
  }
  void align() {
    cnt = 0;
    if (prev_ff) pos += 1;
    prev_ff = false;
  }
  void skip_raw(int64_t k) {
    pos += k;
    prev_ff = false;
  }
};

// ----------------------------------------------------------------- tag tree

struct TagTree {
  int w = 0, h = 0;
  std::vector<std::pair<int, int>> levels;  // root-first (w, h)
  std::vector<std::vector<int32_t>> value, state;

  void init(int w_, int h_) {
    w = w_; h = h_;
    levels.clear();
    int lw = w, lh = h;
    std::vector<std::pair<int, int>> tmp;
    for (;;) {
      tmp.push_back({lw, lh});
      if (lw == 1 && lh == 1) break;
      lw = (lw + 1) / 2; lh = (lh + 1) / 2;
    }
    levels.assign(tmp.rbegin(), tmp.rend());
    value.clear(); state.clear();
    for (auto& [vw, vh] : levels) {
      value.push_back(std::vector<int32_t>((size_t)vw * vh, 0));
      state.push_back(std::vector<int32_t>((size_t)vw * vh, 0));
    }
  }

  int32_t decode(BitReader& br, int x, int y, int threshold) {
    int lo = 0;
    int nl = (int)levels.size();
    for (int li = 0; li < nl; li++) {
      int shift = nl - 1 - li;
      int xi = x >> shift, yi = y >> shift;
      int lw = levels[li].first;
      int32_t& st = state[li][(size_t)yi * lw + xi];
      int32_t& va = value[li][(size_t)yi * lw + xi];
      if (st < lo) { st = lo; if (va < lo) va = lo; }
      while (st < threshold && va == st) {
        if (br.bit()) { va = st; st += 1; break; }
        st += 1; va = st;
      }
      lo = st < va ? st : va;
    }
    int lw = levels[nl - 1].first;
    return value[nl - 1][(size_t)y * lw + x];
  }
};

// --------------------------------------------------------------- structures

struct CodeBlock {
  int x0, y0, x1, y1;
  bool included = false;
  int n_zero_bitplanes = 0;
  int lblock = 3;
  int n_passes = 0;
  std::vector<uint8_t> data;
};

struct Band {
  int orient;                  // 0 LL, 1 HL, 2 LH, 3 HH
  int x0, y0, x1, y1;
  int n_cb_x = 0, n_cb_y = 0;
  std::vector<CodeBlock> cblks;  // row-major grid
  TagTree inc_tree, zbp_tree;
  std::vector<int32_t> decoded;  // (y1-y0) x (x1-x0)
};

struct CodingParams {
  int n_levels = 5;
  int cb_w = 64, cb_h = 64;
  int cblk_style = 0;
  int transform = 1;
  int prog_order = 0;
  int n_layers = 1;
  bool sop = false, eph = false;
  int guard_bits = 2;
  std::vector<int> band_exps;
};

struct Siz {
  int64_t xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz;
  int prec;
  bool is_signed;
};

static inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;  // operands here are non-negative or handled
}
static inline int64_t ceil_div_s(int64_t a, int64_t b) {
  // signed-safe ceil for possibly negative numerators
  if (a >= 0) return (a + b - 1) / b;
  return -((-a) / b);
}

// ---------------------------------------------------------------- tier-1

static const int SC_CTX[3][3] = {  // [hc+1][vc+1] -> context
    {13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
static const int SC_XOR[3][3] = {
    {1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
// NB: indexed [hc+1][vc+1] with hc,vc in {-1,0,1}; table mirrors
// _SC_TABLE in io/j2k.py ((1,1)->13/0 etc).

static int zc_context(int orient, int h, int v, int d) {
  if (orient == 3) {
    int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv >= 1 ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
    return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
  }
  if (orient == 1) { int t = h; h = v; v = t; }
  if (h == 2) return 8;
  if (h == 1) {
    if (v >= 1) return 7;
    return d >= 1 ? 6 : 5;
  }
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : (d == 1 ? 1 : 0);
}

static void decode_cblk(MQDecoder& mq, int w, int h, int orient,
                        int n_bitplanes, int n_passes, bool segsym,
                        int32_t* out /* w*h */) {
  int W = w + 2, H = h + 2;
  std::vector<uint8_t> sig((size_t)W * H, 0);
  std::vector<int8_t> sgn((size_t)W * H, 0);
  std::vector<uint8_t> visited((size_t)w * h, 0);
  std::vector<uint8_t> refined((size_t)w * h, 0);
  std::vector<int32_t> mag((size_t)w * h, 0);

  auto S = [&](int y, int x) -> uint8_t& {
    return sig[(size_t)(y + 1) * W + (x + 1)];
  };
  auto G = [&](int y, int x) -> int8_t& {
    return sgn[(size_t)(y + 1) * W + (x + 1)];
  };
  auto nbhd = [&](int y, int x, int& hs, int& vs, int& ds) {
    hs = S(y, x - 1) + S(y, x + 1);
    vs = S(y - 1, x) + S(y + 1, x);
    ds = S(y - 1, x - 1) + S(y - 1, x + 1) + S(y + 1, x - 1)
       + S(y + 1, x + 1);
  };
  auto decode_sign = [&](int y, int x) -> int {
    int hc = S(y, x - 1) * G(y, x - 1) + S(y, x + 1) * G(y, x + 1);
    int vc = S(y - 1, x) * G(y - 1, x) + S(y + 1, x) * G(y + 1, x);
    hc = hc > 1 ? 1 : (hc < -1 ? -1 : hc);
    vc = vc > 1 ? 1 : (vc < -1 ? -1 : vc);
    int cx = SC_CTX[hc + 1][vc + 1];
    int xo = SC_XOR[hc + 1][vc + 1];
    return mq.decode(cx) ^ xo;
  };
  auto set_sig = [&](int y, int x, int neg) {
    S(y, x) = 1;
    G(y, x) = neg ? -1 : 1;
  };

  int pass_idx = 0, bp = n_bitplanes - 1;
  while (pass_idx < n_passes && bp >= 0) {
    int pass_kind = pass_idx == 0 ? 2 : (pass_idx - 1) % 3;
    if (pass_kind == 0) {                    // significance propagation
      std::memset(visited.data(), 0, visited.size());
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
          for (int y = y0; y < y0 + 4 && y < h; y++) {
            if (S(y, x)) continue;
            int hs, vs, ds;
            nbhd(y, x, hs, vs, ds);
            if (hs + vs + ds == 0) continue;
            visited[(size_t)y * w + x] = 1;
            if (mq.decode(zc_context(orient, hs, vs, ds))) {
              set_sig(y, x, decode_sign(y, x));
              mag[(size_t)y * w + x] |= 1 << bp;
            }
          }
    } else if (pass_kind == 1) {             // magnitude refinement
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
          for (int y = y0; y < y0 + 4 && y < h; y++) {
            if (!S(y, x) || visited[(size_t)y * w + x]) continue;
            int cx;
            if (refined[(size_t)y * w + x]) cx = 16;
            else {
              int hs, vs, ds;
              nbhd(y, x, hs, vs, ds);
              cx = (hs + vs + ds) ? 15 : 14;
              refined[(size_t)y * w + x] = 1;
            }
            if (mq.decode(cx)) mag[(size_t)y * w + x] |= 1 << bp;
          }
    } else {                                 // cleanup
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++) {
          int y = y0;
          int stripe_h = h - y0 < 4 ? h - y0 : 4;
          if (stripe_h == 4) {
            bool all_clear = true;
            for (int yy = y0; yy < y0 + 4; yy++) {
              if (visited[(size_t)yy * w + x] || S(yy, x)) {
                all_clear = false; break;
              }
              int hs, vs, ds;
              nbhd(yy, x, hs, vs, ds);
              if (hs + vs + ds) { all_clear = false; break; }
            }
            if (all_clear) {
              if (mq.decode(CTX_RL) == 0) continue;
              int r = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI);
              y = y0 + r;
              set_sig(y, x, decode_sign(y, x));
              mag[(size_t)y * w + x] |= 1 << bp;
              y += 1;
            }
          }
          for (int yy = y; yy < y0 + stripe_h; yy++) {
            if (visited[(size_t)yy * w + x] || S(yy, x)) continue;
            int hs, vs, ds;
            nbhd(yy, x, hs, vs, ds);
            if (mq.decode(zc_context(orient, hs, vs, ds))) {
              set_sig(yy, x, decode_sign(yy, x));
              mag[(size_t)yy * w + x] |= 1 << bp;
            }
          }
        }
      if (segsym)
        for (int i = 0; i < 4; i++) (void)mq.decode(CTX_UNI);
      bp -= 1;
    }
    pass_idx += 1;
  }

  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      int32_t v = mag[(size_t)y * w + x];
      out[(size_t)y * w + x] = G(y, x) < 0 ? -v : v;
    }
}

// ------------------------------------------------------------ band geometry

static void build_bands(int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1,
                        const CodingParams& cp,
                        std::vector<std::vector<Band>>& res) {
  res.clear();
  for (int r = 0; r <= cp.n_levels; r++) {
    int nb = cp.n_levels - r;
    std::vector<Band> bands;
    if (r == 0) {
      Band b; b.orient = 0;
      b.x0 = (int)ceil_div_s(tx0, (int64_t)1 << nb);
      b.y0 = (int)ceil_div_s(ty0, (int64_t)1 << nb);
      b.x1 = (int)ceil_div_s(tx1, (int64_t)1 << nb);
      b.y1 = (int)ceil_div_s(ty1, (int64_t)1 << nb);
      bands.push_back(std::move(b));
    } else {
      int sh = nb + 1;
      for (int orient = 1; orient <= 3; orient++) {
        int xo = (orient == 1 || orient == 3) ? 1 : 0;
        int yo = (orient == 2 || orient == 3) ? 1 : 0;
        Band b; b.orient = orient;
        int64_t half = (int64_t)1 << (sh - 1);
        b.x0 = (int)ceil_div_s(tx0 - half * xo, (int64_t)1 << sh);
        b.y0 = (int)ceil_div_s(ty0 - half * yo, (int64_t)1 << sh);
        b.x1 = (int)ceil_div_s(tx1 - half * xo, (int64_t)1 << sh);
        b.y1 = (int)ceil_div_s(ty1 - half * yo, (int64_t)1 << sh);
        bands.push_back(std::move(b));
      }
    }
    for (auto& band : bands) {
      int bw = band.x1 - band.x0, bh = band.y1 - band.y0;
      if (bw <= 0 || bh <= 0) { band.n_cb_x = band.n_cb_y = 0; continue; }
      int cbx0 = band.x0 / cp.cb_w;
      int cby0 = band.y0 / cp.cb_h;
      int cbx1 = (int)ceil_div(band.x1, cp.cb_w);
      int cby1 = (int)ceil_div(band.y1, cp.cb_h);
      band.n_cb_x = cbx1 - cbx0;
      band.n_cb_y = cby1 - cby0;
      band.cblks.resize((size_t)band.n_cb_x * band.n_cb_y);
      for (int j = 0; j < band.n_cb_y; j++)
        for (int i = 0; i < band.n_cb_x; i++) {
          CodeBlock& cb = band.cblks[(size_t)j * band.n_cb_x + i];
          cb.x0 = std::max(band.x0, (cbx0 + i) * cp.cb_w);
          cb.y0 = std::max(band.y0, (cby0 + j) * cp.cb_h);
          cb.x1 = std::min(band.x1, (cbx0 + i + 1) * cp.cb_w);
          cb.y1 = std::min(band.y1, (cby0 + j + 1) * cp.cb_h);
        }
      band.inc_tree.init(band.n_cb_x, band.n_cb_y);
      band.zbp_tree.init(band.n_cb_x, band.n_cb_y);
      band.decoded.assign((size_t)bw * bh, 0);
    }
    res.push_back(std::move(bands));
  }
}

// ----------------------------------------------------------------- packets

static int int_log2(int v) {
  int r = 0;
  while ((1 << (r + 1)) <= v) r += 1;
  return r;
}

static int n_passes_decode(BitReader& br) {
  if (br.bit() == 0) return 1;
  if (br.bit() == 0) return 2;
  uint32_t v = br.bits(2);
  if (v < 3) return 3 + (int)v;
  v = br.bits(5);
  if (v < 31) return 6 + (int)v;
  return 37 + (int)br.bits(7);
}

struct Contrib { Band* band; CodeBlock* cblk; int n_passes; int64_t off, len; };

static void decode_packet(BitReader& br, std::vector<Band>& bands, int layer,
                          bool eph_on, std::vector<Contrib>& contribs) {
  // EPH terminates the packet HEADER — skip it BEFORE the bodies
  auto eph = [&]() {
    if (eph_on && br.pos + 2 <= br.n && br.data[br.pos] == 0xFF
        && br.data[br.pos + 1] == 0x92)
      br.skip_raw(2);
  };
  if (br.bit() == 0) { br.align(); eph(); return; }
  struct Pending { Band* band; CodeBlock* cblk; int n_passes; int64_t len; };
  std::vector<Pending> blocks;
  for (auto& band : bands) {
    if (band.n_cb_x == 0) continue;
    for (int j = 0; j < band.n_cb_y; j++)
      for (int i = 0; i < band.n_cb_x; i++) {
        CodeBlock& cb = band.cblks[(size_t)j * band.n_cb_x + i];
        bool incl;
        if (!cb.included)
          incl = band.inc_tree.decode(br, i, j, layer + 1) <= layer;
        else
          incl = br.bit() != 0;
        if (!incl) continue;
        if (!cb.included) {
          cb.included = true;
          int k = 1;
          while (band.zbp_tree.decode(br, i, j, k) >= k) k += 1;
          cb.n_zero_bitplanes = k - 1;
        }
        int np = n_passes_decode(br);
        while (br.bit()) cb.lblock += 1;
        int bits = cb.lblock + int_log2(np);
        int64_t ln = br.bits(bits);
        blocks.push_back({&band, &cb, np, ln});
      }
  }
  br.align();
  eph();
  for (auto& b : blocks) {
    contribs.push_back({b.band, b.cblk, b.n_passes, br.pos, b.len});
    br.skip_raw(b.len);
    if (br.pos > br.n) throw std::runtime_error("packet body overrun");
  }
}

// ------------------------------------------------------------ inverse DWT

static void lift53(std::vector<int64_t>& buf, int n, int origin,
                   std::vector<int64_t>& tmp) {
  if (n <= 1) {
    if (n == 1 && ((origin % 2 + 2) % 2) == 1)
      buf[0] >>= 1;  // arithmetic shift = floor div (python //)
    return;
  }
  auto at = [&](int i) -> int64_t {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    return tmp[i];
  };
  tmp.assign(buf.begin(), buf.begin() + n);
  int par = ((origin % 2) + 2) % 2;
  // step 1: even absolute positions
  for (int i = 0; i < n; i++)
    if (((par + i) % 2) == 0)
      buf[i] = tmp[i] - ((at(i - 1) + at(i + 1) + 2) >> 2);
  tmp.assign(buf.begin(), buf.begin() + n);
  for (int i = 0; i < n; i++)
    if (((par + i) % 2) == 1)
      buf[i] = tmp[i] + ((at(i - 1) + at(i + 1)) >> 1);
}

// in-place one-level inverse on an interleaved (h x w) grid
static void idwt53_level(std::vector<int64_t>& out, int w, int h,
                         int ux0, int uy0,
                         const Band& hl, const Band& lh, const Band& hh,
                         const std::vector<int64_t>& ll, int llw, int llh) {
  int ex = ((ux0 % 2) + 2) % 2, ey = ((uy0 % 2) + 2) % 2;
  int ysl = (0 - ey + 2) % 2, xsl = (0 - ex + 2) % 2;
  // place LL
  for (int j = 0; j < llh; j++)
    for (int i = 0; i < llw; i++)
      out[(size_t)(ysl + 2 * j) * w + (xsl + 2 * i)] = ll[(size_t)j * llw + i];
  int hlw = hl.x1 - hl.x0, hlh = hl.y1 - hl.y0;
  for (int j = 0; j < hlh; j++)
    for (int i = 0; i < hlw; i++)
      out[(size_t)(ysl + 2 * j) * w + ((1 - xsl) + 2 * i)] =
          hlw > 0 ? hl.decoded[(size_t)j * hlw + i] : 0;
  int lhw = lh.x1 - lh.x0, lhh = lh.y1 - lh.y0;
  for (int j = 0; j < lhh; j++)
    for (int i = 0; i < lhw; i++)
      out[(size_t)((1 - ysl) + 2 * j) * w + (xsl + 2 * i)] =
          lhw > 0 ? lh.decoded[(size_t)j * lhw + i] : 0;
  int hhw = hh.x1 - hh.x0, hhh = hh.y1 - hh.y0;
  for (int j = 0; j < hhh; j++)
    for (int i = 0; i < hhw; i++)
      out[(size_t)((1 - ysl) + 2 * j) * w + ((1 - xsl) + 2 * i)] =
          hhw > 0 ? hh.decoded[(size_t)j * hhw + i] : 0;

  // horizontal then vertical lifting (inverse of the forward order)
  std::vector<int64_t> line, tmp;
  line.resize(std::max(w, h));
  for (int j = 0; j < h; j++) {
    for (int i = 0; i < w; i++) line[i] = out[(size_t)j * w + i];
    line.resize(w);
    lift53(line, w, ux0, tmp);
    line.resize(std::max(w, h));
    for (int i = 0; i < w; i++) out[(size_t)j * w + i] = line[i];
  }
  for (int i = 0; i < w; i++) {
    for (int j = 0; j < h; j++) line[j] = out[(size_t)j * w + i];
    line.resize(h);
    lift53(line, h, uy0, tmp);
    line.resize(std::max(w, h));
    for (int j = 0; j < h; j++) out[(size_t)j * w + i] = line[j];
  }
}

// --------------------------------------------------------------- the tile

static void decode_tile(const uint8_t* tdata, int64_t tlen,
                        const CodingParams& cp,
                        int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1,
                        std::vector<int64_t>& tile_out) {
  std::vector<std::vector<Band>> res;
  build_bands(tx0, ty0, tx1, ty1, cp, res);
  BitReader br(tdata, tlen);
  std::vector<Contrib> contribs;

  auto packet = [&](int r, int layer) {
    if (cp.sop && br.pos + 2 <= br.n && tdata[br.pos] == 0xFF
        && tdata[br.pos + 1] == 0x91)
      br.skip_raw(6);
    decode_packet(br, res[r], layer, cp.eph, contribs);
  };

  if (cp.prog_order == 0) {
    for (int layer = 0; layer < cp.n_layers; layer++)
      for (int r = 0; r <= cp.n_levels; r++) packet(r, layer);
  } else {
    for (int r = 0; r <= cp.n_levels; r++)
      for (int layer = 0; layer < cp.n_layers; layer++) packet(r, layer);
  }

  // merge layer contributions per code-block (FIFO order preserved)
  struct Merged { Band* band; int r; CodeBlock* cblk; int n_passes;
                  std::vector<uint8_t> data; };
  std::vector<Merged> merged;
  for (auto& c : contribs) {
    Merged* m = nullptr;
    for (auto& mm : merged)
      if (mm.cblk == c.cblk) { m = &mm; break; }
    if (!m) {
      int r = 0;
      for (size_t ri = 0; ri < res.size(); ri++)
        for (auto& band : res[ri])
          if (&band == c.band) r = (int)ri;
      merged.push_back({c.band, r, c.cblk, 0, {}});
      m = &merged.back();
    }
    m->n_passes += c.n_passes;
    m->data.insert(m->data.end(), tdata + c.off, tdata + c.off + c.len);
  }

  for (auto& m : merged) {
    int w = m.cblk->x1 - m.cblk->x0, h = m.cblk->y1 - m.cblk->y0;
    if (w <= 0 || h <= 0 || m.data.empty()) continue;
    MQDecoder mq(m.data.data(), (int64_t)m.data.size());
    int idx = m.r == 0 ? 0 : 1 + 3 * (m.r - 1) + (m.band->orient - 1);
    int exp = idx < (int)cp.band_exps.size()
                  ? cp.band_exps[idx]
                  : 8 + (m.band->orient == 3 ? 1 : 0);
    int mb = cp.guard_bits + exp - 1;
    int n_bp = mb - m.cblk->n_zero_bitplanes;
    std::vector<int32_t> coeffs((size_t)w * h);
    decode_cblk(mq, w, h, m.band->orient, n_bp, m.n_passes,
                (cp.cblk_style & 0x20) != 0, coeffs.data());
    int bw = m.band->x1 - m.band->x0;
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        m.band->decoded[(size_t)(m.cblk->y0 - m.band->y0 + y) * bw
                        + (m.cblk->x0 - m.band->x0 + x)] =
            coeffs[(size_t)y * w + x];
  }

  // inverse DWT across levels
  Band& ll0 = res[0][0];
  std::vector<int64_t> ll(ll0.decoded.begin(), ll0.decoded.end());
  int llw = std::max(ll0.x1 - ll0.x0, 0), llh = std::max(ll0.y1 - ll0.y0, 0);
  for (int r = 1; r <= cp.n_levels; r++) {
    int nb = cp.n_levels - r;
    int64_t ux0 = ceil_div_s(tx0, (int64_t)1 << nb);
    int64_t uy0 = ceil_div_s(ty0, (int64_t)1 << nb);
    int64_t ux1 = ceil_div_s(tx1, (int64_t)1 << nb);
    int64_t uy1 = ceil_div_s(ty1, (int64_t)1 << nb);
    int w = (int)(ux1 - ux0), h = (int)(uy1 - uy0);
    std::vector<int64_t> out((size_t)w * h, 0);
    idwt53_level(out, w, h, (int)ux0, (int)uy0,
                 res[r][0], res[r][1], res[r][2], ll, llw, llh);
    ll.swap(out);
    llw = w; llh = h;
  }
  tile_out.swap(ll);
}

// ------------------------------------------------------------- main header

static uint32_t rd32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
       | ((uint32_t)p[2] << 8) | p[3];
}
static uint32_t rd16(const uint8_t* p) {
  return ((uint32_t)p[0] << 8) | p[1];
}

}  // namespace

extern "C" int32_t boa_j2k_decode(const char* cdata, int64_t len,
                                  void* out_buf, int64_t out_cap,
                                  int32_t* rows_out, int32_t* cols_out) {
  try {
    const uint8_t* data = (const uint8_t*)cdata;
    if (len < 4 || data[0] != 0xFF || data[1] != 0x4F) return 2;
    Siz siz{};
    bool have_siz = false;
    CodingParams cp;
    struct Tile { int isot; int64_t off, len; };
    std::vector<Tile> tiles;
    int64_t pos = 2;
    while (pos + 2 <= len) {
      if (data[pos] != 0xFF) return 3;
      int marker = data[pos + 1];
      pos += 2;
      if (marker == 0xD9) break;          // EOC
      if (pos + 2 > len) return 3;
      int64_t ln = rd16(data + pos);
      const uint8_t* seg = data + pos + 2;
      int64_t seg_len = ln - 2;
      if (pos + ln > len) return 3;
      if (marker == 0x51) {               // SIZ
        if (seg_len < 38) return 3;
        siz.xsiz = rd32(seg + 2); siz.ysiz = rd32(seg + 6);
        siz.xosiz = rd32(seg + 10); siz.yosiz = rd32(seg + 14);
        siz.xtsiz = rd32(seg + 18); siz.ytsiz = rd32(seg + 22);
        siz.xtosiz = rd32(seg + 26); siz.ytosiz = rd32(seg + 30);
        if (siz.xtsiz <= 0 || siz.ytsiz <= 0 || siz.xsiz <= siz.xosiz
            || siz.ysiz <= siz.yosiz || siz.xtosiz > siz.xosiz
            || siz.ytosiz > siz.yosiz)
          return 3;                         // malformed geometry
        if (rd16(seg + 34) != 1) return 4;  // single component only
        siz.prec = (seg[36] & 0x7F) + 1;
        siz.is_signed = (seg[36] & 0x80) != 0;
        if (seg[37] != 1 || seg[38] != 1) return 4;
        have_siz = true;
      } else if (marker == 0x52) {        // COD
        int scod = seg[0];
        cp.sop = (scod & 2) != 0;
        cp.eph = (scod & 4) != 0;
        cp.prog_order = seg[1];
        cp.n_layers = (int)rd16(seg + 2);
        if (seg[4] != 0) return 4;        // MCT
        cp.n_levels = seg[5];
        cp.cb_w = 1 << ((seg[6] & 0x0F) + 2);
        cp.cb_h = 1 << ((seg[7] & 0x0F) + 2);
        cp.cblk_style = seg[8];
        if (cp.cblk_style != 0 && cp.cblk_style != 0x20) return 5;
        cp.transform = seg[9];
        if (cp.transform != 1) return 6;  // reversible 5/3 only
        if (scod & 1) {
          for (int64_t i = 10; i < seg_len; i++)
            if ((seg[i] & 0x0F) != 15 || (seg[i] >> 4) != 15) return 7;
        }
      } else if (marker == 0x5C) {        // QCD
        int sqcd = seg[0];
        if ((sqcd & 0x1F) != 0) return 6;
        cp.guard_bits = sqcd >> 5;
        cp.band_exps.clear();
        for (int64_t i = 1; i < seg_len; i++)
          cp.band_exps.push_back(seg[i] >> 3);
      } else if (marker == 0x90) {        // SOT
        if (seg_len < 8) return 3;
        int isot = (int)rd16(seg);
        int64_t psot = rd32(seg + 2);
        int tpsot = seg[6], tnsot = seg[7];
        if (tpsot != 0 || (tnsot != 0 && tnsot != 1)) return 8;
        // tile-part header markers until SOD (PLT/COM skippable)
        int64_t p2 = pos + ln;
        for (;;) {
          if (p2 + 2 > len || data[p2] != 0xFF) return 3;
          int m2 = data[p2 + 1];
          if (m2 == 0x93) break;
          if (m2 == 0x61) return 4;        // PPT unsupported
          if (m2 != 0x58 && m2 != 0x64) return 4;  // PLT / COM only
          if (p2 + 4 > len) return 3;
          p2 += 2 + rd16(data + p2 + 2);
        }
        int64_t start = p2 + 2;
        int64_t end = pos - 2 + (psot ? psot : (len - (pos - 2)));
        if (end > len) return 3;
        tiles.push_back({isot, start, end - start});
        pos = end;
        continue;
      } else if (marker == 0x53 || marker == 0x5D || marker == 0x5F
                 || marker == 0x60 || marker == 0x61) {
        return 4;                         // COC/QCC/POC/PPM/PPT
      }
      pos += ln;
    }
    if (!have_siz) return 3;

    int64_t W = siz.xsiz - siz.xosiz, H = siz.ysiz - siz.yosiz;
    if (rows_out) *rows_out = (int32_t)H;
    if (cols_out) *cols_out = (int32_t)W;
    if (out_cap < W * H) return 9;
    uint16_t* out = (uint16_t*)out_buf;
    int64_t n_tx = ceil_div(siz.xsiz - siz.xtosiz, siz.xtsiz);
    int32_t dc = siz.is_signed ? 0 : (1 << (siz.prec - 1));

    for (auto& t : tiles) {
      int64_t ti = t.isot % n_tx, tj = t.isot / n_tx;
      int64_t tx0 = std::max(siz.xtosiz + ti * siz.xtsiz, siz.xosiz);
      int64_t ty0 = std::max(siz.ytosiz + tj * siz.ytsiz, siz.yosiz);
      int64_t tx1 = std::min(siz.xtosiz + (ti + 1) * siz.xtsiz, siz.xsiz);
      int64_t ty1 = std::min(siz.ytosiz + (tj + 1) * siz.ytsiz, siz.ysiz);
      std::vector<int64_t> tile;
      decode_tile(data + t.off, t.len, cp, tx0, ty0, tx1, ty1, tile);
      int tw = (int)(tx1 - tx0), th = (int)(ty1 - ty0);
      for (int y = 0; y < th; y++)
        for (int x = 0; x < tw; x++) {
          int64_t v = tile[(size_t)y * tw + x] + dc;
          out[(size_t)(ty0 - siz.yosiz + y) * W + (tx0 - siz.xosiz + x)] =
              (uint16_t)((uint64_t)v & 0xFFFF);
        }
    }
    return 0;
  } catch (...) {
    return 1;
  }
}
