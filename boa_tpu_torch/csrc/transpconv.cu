// 2x2x2 stride-2 transposed conv with its bias (the decoder's last
// upsample) for Hopper (sm_90a), bf16 in, fp32 accumulate, channels-last.
//
// Replaces: boa_tpu/ops/rowconv.py `_transp_kernel`. Contract:
//   out[n, 2x+a, 2y+b, 2z+c, co] = sum_ci x[n, x, y, z, ci] * w[a, b, c, ci, co] + bias[co]
// with the bias in fp32 and the sum rounded once. The output is any
// channels-last buffer whose voxels lie ldy elements apart (ldy >= cout),
// so the kernel can write the first channels of the decoder concat.
//
// What bounds it on an H100: at the main path's shape (64^3 x 64 -> 128^3 x
// 32) it moves 34 MB in and 134 MB out for 8.6 GFLOP, ~51 FLOP/byte: memory
// bound (0.05 ms at 3.35 TB/s against 0.009 ms of tensor-core time), and
// four fifths of the bytes are the output. So the design streams the input
// once and writes the output in whole 16-byte pieces:
//
// Every output voxel receives exactly one tap, so the op is one GEMM
// [voxels x cin] . [cin x 8*cout]. A persistent block of 8 warps stages the
// packed weights (cin x 8*cout bf16, 32 KB at 64 -> 32) into shared memory
// once, then walks tiles of BM consecutive input voxels: the A tile of the
// next tile lands through cp.async while the current one multiplies. Warp w
// owns parity pair (a, b) = w % 4 (its 2*cout columns (c, co)) and half of
// the tile's rows, and multiplies with `mma.sync` m16n8k16: A through
// `ldmatrix` from the staged tile (voxel stride cin + 8, conflict-free), B in
// per-lane fragment order from shared memory. The epilogue adds the fp32
// bias to the accumulators, rounds once, and transposes the warp's rows
// through a small shared-memory buffer, so that each lane writes 16 bytes
// and a warp writes whole runs of cout channels of consecutive output
// voxels (2z, 2z + 1 of each input row). Each row's output position is
// decoded once per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using boa::cp_async16;
using boa::cp_async_commit;
using boa::cp_async_wait;
using boa::ldmatrix_x4;
using boa::mma_bf16;
using boa::store2;

constexpr int kWarps = 8;  // 4 (a, b) parity pairs x 2 row halves
constexpr int kThreads = 32 * kWarps;

template <int COUT, typename OutT>
struct Geo {
  static constexpr int NCOL = 2 * COUT;                     // (c, co) columns of a pair
  static constexpr int NT = NCOL / 8;                       // n8 tiles per warp
  static constexpr int NP = NCOL / 16;                      // 16-byte B loads per lane and k step
  static constexpr int MW = COUT == 64 ? 1 : 2;             // A fragments per warp
  static constexpr int BM = 2 * 16 * MW;                    // input voxels per tile
  static constexpr int RS = NCOL * (int)sizeof(OutT) + 16;  // staging row bytes (padded)
  static constexpr int VEC = COUT * (int)sizeof(OutT) / 16; // 16-byte stores per output voxel
};

template <int COUT, typename OutT>
size_t smem_bytes(int cin) {
  using G = Geo<COUT, OutT>;
  return (size_t)4 * cin * G::NCOL * 2           // weights
         + (size_t)2 * G::BM * (cin + 8) * 2     // two A tiles
         + (size_t)G::BM * 8                     // row output positions
         + (size_t)kWarps * 16 * G::MW * G::RS;  // per-warp staging
}

template <int COUT, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    transp_kernel(const __nv_bfloat16* __restrict__ x,  // (M, cin), M = N*X*Y*Z
                  const uint4* __restrict__ wpk,        // B fragments, see boa_transpconv2_fwd
                  const float* __restrict__ bias,       // (COUT,)
                  OutT* __restrict__ y,                 // (N, 2X, 2Y, 2Z) voxels, ldy apart
                  long long M, int X, int Y, int Z, int cin, int ldy, int ntiles) {
  using G = Geo<COUT, OutT>;
  constexpr int MW = G::MW, NT = G::NT, NP = G::NP, BM = G::BM, RS = G::RS, VEC = G::VEC;
  constexpr int ROWS = 16 * MW;  // rows per warp
  const int CS = cin + 8;        // A tile voxel stride: (CS / 8) odd keeps ldmatrix conflict-free
  const int KC = cin / 16;
  const int C8 = cin / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wsm = reinterpret_cast<uint4*>(smem);  // (4, KC, NP, 32)
  const int wunits = 4 * KC * NP * 32;
  __nv_bfloat16* abuf = reinterpret_cast<__nv_bfloat16*>(wsm + wunits);  // (2, BM, CS)
  long long* rowpos = reinterpret_cast<long long*>(abuf + 2 * BM * CS);  // (BM,)
  unsigned char* stage = reinterpret_cast<unsigned char*>(rowpos + BM);   // (kWarps, ROWS, RS)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ab = warp & 3, mh = warp >> 2;
  const int g = lane >> 2, t = lane & 3;

  auto load_a = [&](int buf, int tile) {
    const long long m0 = (long long)tile * BM;
    __nv_bfloat16* dst = abuf + buf * BM * CS;
    for (int u = tid; u < BM * C8; u += kThreads) {
      const int r = u / C8, c = u - r * C8;
      if (m0 + r < M) cp_async16(dst + r * CS + c * 8, x + (m0 + r) * cin + c * 8);
    }
  };

  for (int i = tid; i < wunits; i += kThreads) cp_async16(wsm + i, wpk + i);
  int tile = blockIdx.x;
  if (tile < ntiles) load_a(0, tile);
  cp_async_commit();

  float bv[NT][2];  // lane's columns 8j + 2t + e are (c, co) with co = column % COUT
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[j][e] = bias[(8 * j + 2 * t + e) % COUT];

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const uint32_t abase = static_cast<uint32_t>(__cvta_generic_to_shared(abuf)) +
                         (uint32_t)((mh * ROWS + a_row) * CS + a_col) * 2;
  const long long pair_off = ((long long)(ab >> 1) * 2 * Y + (ab & 1)) * 2 * Z;
  unsigned char* st = stage + warp * ROWS * RS;

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < ntiles) load_a((it + 1) & 1, next);
    cp_async_commit();
    if (tid < BM) {  // output voxel (n, 2x, 2y, 2z) of each input row, -1 past M
      const long long m = (long long)tile * BM + tid;
      long long pos = -1;
      if (m < M) {
        const int z = (int)(m % Z);
        long long r = m / Z;
        const int yy = (int)(r % Y);
        r /= Y;
        const int xx = (int)(r % X);
        const long long n = r / X;
        pos = ((n * 2 * X + 2 * xx) * 2 * Y + 2 * yy) * 2 * Z + 2 * z;
      }
      rowpos[tid] = pos;
    }
    cp_async_wait<1>();  // everything but the newest group: this tile's A (and the weights)
    __syncthreads();

    float acc[MW][NT][4];
#pragma unroll
    for (int f = 0; f < MW; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
    const uint32_t abuf_it = abase + (uint32_t)((it & 1) * BM * CS) * 2;
    const uint4* wb = wsm + ab * KC * NP * 32 + lane;
    for (int kc = 0; kc < KC; ++kc) {
      uint4 b[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) b[p] = wb[(kc * NP + p) * 32];
      uint32_t a[MW][4];
#pragma unroll
      for (int f = 0; f < MW; ++f) ldmatrix_x4(a[f], abuf_it + (uint32_t)(f * 16 * CS) * 2 + kc * 32);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t b0 = (j & 1) ? b[j / 2].z : b[j / 2].x;
        const uint32_t b1 = (j & 1) ? b[j / 2].w : b[j / 2].y;
#pragma unroll
        for (int f = 0; f < MW; ++f) mma_bf16(acc[f][j], a[f], b0, b1);
      }
    }

    // --- epilogue: bias, one rounding, the warp's rows through shared memory.
    //     Lane holds rows g and g + 8 of each fragment, columns 2t, 2t + 1.
#pragma unroll
    for (int f = 0; f < MW; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        OutT* row = reinterpret_cast<OutT*>(st + (f * 16 + g + 8 * h) * RS);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store2(row + 8 * j + 2 * t, acc[f][j][2 * h] + bv[j][0], acc[f][j][2 * h + 1] + bv[j][1]);
      }
    __syncwarp();
    // unit u: row r, z parity c, 16-byte piece q of the voxel's cout channels
#pragma unroll 4
    for (int u = lane; u < ROWS * 2 * VEC; u += 32) {
      const int r = u / (2 * VEC), c = (u / VEC) & 1, q = u % VEC;
      const long long pos = rowpos[mh * ROWS + r];
      if (pos < 0) continue;
      const uint4 v =
          *reinterpret_cast<const uint4*>(st + r * RS + c * COUT * (int)sizeof(OutT) + q * 16);
      *reinterpret_cast<uint4*>(y + (pos + pair_off + c) * ldy + q * (16 / (int)sizeof(OutT))) = v;
    }
    __syncthreads();  // A buffer, row positions and staging are free for the next tile
  }
  cp_async_wait<0>();
}

template <int COUT, typename OutT>
int launch_transp(const void* x, const void* w, const void* bias, void* y, int N, int X, int Y,
                  int Z, int cin, int ldy, cudaStream_t st) {
  using G = Geo<COUT, OutT>;
  const long long M = (long long)N * X * Y * Z;
  const int ntiles = (int)((M + G::BM - 1) / G::BM);
  const size_t bytes = smem_bytes<COUT, OutT>(cin);
  auto kern = transp_kernel<COUT, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;  // persistent blocks
  if (grid < 1) return 0;
  kern<<<grid, kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(x),
                                      static_cast<const uint4*>(w),
                                      static_cast<const float*>(bias), static_cast<OutT*>(y), M,
                                      X, Y, Z, cin, ldy, ntiles);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch_cout(const void* x, const void* w, const void* bias, void* y, int N, int X, int Y,
                  int Z, int cin, int cout, int ldy, cudaStream_t st) {
  switch (cout) {
    case 8: return launch_transp<8, OutT>(x, w, bias, y, N, X, Y, Z, cin, ldy, st);
    case 16: return launch_transp<16, OutT>(x, w, bias, y, N, X, Y, Z, cin, ldy, st);
    case 32: return launch_transp<32, OutT>(x, w, bias, y, N, X, Y, Z, cin, ldy, st);
    case 64: return launch_transp<64, OutT>(x, w, bias, y, N, X, Y, Z, cin, ldy, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch (0 on success).
//   x     (N, X, Y, Z, cin) bf16, contiguous, 16-byte aligned; cin a
//         multiple of 16, at most 128
//   w     B fragments: for pair ab = 2a + b, k chunk kc < cin/16, column
//         pair p < cout/8 and lane = 4g + t, the 16 bytes at index
//         ((ab*(cin/16) + kc)*(cout/8) + p)*32 + lane hold the bf16 values
//         W[ab][kc*16 + 8h + 2t + e][p*16 + 8q + g] in (q, h, e) order, where
//         W[ab][ci][c*cout + co] = w[a, b, c, ci, co]
//   bias  (cout,) float32
//   y     output voxel (n, X', Y', Z') at element ((n*2X + X')*2Y + Y')*2Z + Z'
//         times ldy, its cout channels contiguous; 16-byte aligned, ldy a
//         multiple of 16 bytes; bf16 or float32 (out_f32). cout one of
//         8/16/32/64.
extern "C" int boa_transpconv2_fwd(const void* x, const void* w, const void* bias, void* y, int N,
                                   int X, int Y, int Z, int cin, int cout, int ldy, int out_f32,
                                   void* stream) {
  if (cin % 16 != 0 || cin < 16 || cin > 128 || ldy < cout) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch_cout<float>(x, w, bias, y, N, X, Y, Z, cin, cout, ldy, st)
                 : dispatch_cout<__nv_bfloat16>(x, w, bias, y, N, X, Y, Z, cin, cout, ldy, st);
}
