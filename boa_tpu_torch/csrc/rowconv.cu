// Fused 3x3x3 conv (stride 1 or 2) with input-side instance-norm + LeakyReLU
// and per-channel output sums, for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces: boa_tpu/ops/rowconv.py `_rowconv_kernel` (stride 1),
// `_rowconv_g4_kernel` (the same function with four output rows packed for
// the TPU matrix unit) and `_stride2_kernel` (stride 2). Contract, per
// sample n, input channel ci and output channel co:
//   act(x)  = LeakyReLU_s((x - mean) * scale + beta), scale = inv_std*gamma,
//             s a per-channel slope (1 = identity), zero outside the volume
//             AFTER act (torch pads the normalized tensor with zeros)
//   y[o]    = bias + sum_{d, ci} w[d, ci, co] * act(x)[S*o + d - 1]
//   sums    += (sum y, sum y^2) over live output voxels, from fp32 values
// Rounding points follow the reference: x arrives in bf16, the norm runs in
// fp32, act is rounded to bf16 for the tensor cores, the accumulator and the
// bias are fp32, y is stored in bf16 (or fp32 on request).
//
// What bounds it on an H100: at the main path's shapes (128^3 voxels,
// 32 or 64 channels) the work is 116-232 GFLOP against 0.27-0.4 GB of
// compulsory traffic, i.e. ~300-600 FLOP/byte: compute bound on the bf16
// tensor cores (989 TFLOP/s) by a factor of about 1.5-2 over the 3.35 TB/s
// memory line. So the design feeds the tensor cores from on-chip memory:
//
// An implicit GEMM with M = output voxels, N = cout, K = 27 * cin. A block of
// 4 warps owns one output x row, TY output y rows and 32 output z. It walks
// the three input x planes of its row (dx): each plane's halo window is
// staged into shared memory once, with norm + activation applied on the way
// (normalized activations never touch device memory), then all nine (dy, dz)
// taps of that plane are multiplied out of it. The window keeps channels
// innermost with a voxel stride of cin + 8 elements, so the 16 output z of
// one A fragment are 16 shared-memory rows that `ldmatrix` reads without
// bank conflicts; at stride 2 the window's z slots are stored even-first,
// odd-second, so that stride-2 rows are consecutive slots too. Each warp
// holds MW A fragments (16 output voxels each) against all cout columns and
// multiplies with `mma.sync` m16n8k16 (bf16 in, fp32 accumulate), so every
// B fragment it loads is used MW times. B fragments are packed by the
// wrapper in the exact per-lane register order, so a warp reads them with
// coalesced 16-byte loads (they stay in L1/L2: at most 110 KB of weights),
// one step ahead of use. While staging, each thread keeps the loads of
// kBatch window units in flight before it normalizes any. The epilogue adds
// the fp32 bias, stores y from registers, and reduces sum/sum^2 with warp
// shuffles and shared memory before one atomicAdd per channel and block.
// Four blocks share an SM (at most 128 registers a thread), so one block's
// staging overlaps the others' products. Not yet done (later work):
// wgmma/TMA, overlapping a plane's staging with the same block's products,
// weights in shared memory with persistent blocks, a dedicated path for
// cin = 1 (now zero-padded to 16 channels in shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using boa::act8;
using boa::ldmatrix_x4;
using boa::mma_bf16;
using boa::store2;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTZ = 32;    // output z per block: two 16-row A fragments
constexpr int kBatch = 8;  // staging units whose loads a thread keeps in flight

// Block geometry for stride S and COUT (padded) output channels.
template <int S, int COUT>
struct Tile {
  static constexpr int MW = COUT <= 32 ? 4 : 2;  // A fragments per warp
  static constexpr int NT = COUT / 8;            // n8 column tiles
  static constexpr int NB = NT / 2;              // 16-byte B loads per lane and k step
  static constexpr int TY = kWarps * MW / 2;     // output y rows per block
  static constexpr int WY = S * (TY - 1) + 3;    // window y rows
  static constexpr int WZ = S * (kTZ - 1) + 3;   // window z slots
  static constexpr int HALF = (WZ + 1) / 2;      // even z slots come first at stride 2
};

template <int S>
__device__ __forceinline__ int zslot(int iz, int half) {
  return S == 1 ? iz : ((iz & 1) ? half + (iz >> 1) : (iz >> 1));
}

// Slot offset of tap dz from the slot of input z = S * (output z).
template <int S>
__host__ __device__ constexpr int dz_slot(int dz, int half) {
  return S == 1 ? dz : (dz == 1 ? half : dz / 2);
}

template <int S, int COUT, typename OutT>
__global__ void __launch_bounds__(kThreads, 4)  // 4 blocks per SM: at most 128 registers
    rowconv_kernel(const __nv_bfloat16* __restrict__ x,  // (N, X, Y, Z, cin)
                   const float* __restrict__ norm,       // (N, 4, cin_k)
                   const uint4* __restrict__ wpk,        // B fragments, see boa_rowconv_fwd
                   const float* __restrict__ bias,       // (COUT,)
                   OutT* __restrict__ y,                 // (N, Xo, Yo, Zo, COUT)
                   float* __restrict__ sums,             // (N, 2, COUT)
                   int X, int Y, int Z, int cin, int cin_k, int Xo, int Yo, int Zo) {
  using T = Tile<S, COUT>;
  constexpr int MW = T::MW, NT = T::NT, NB = T::NB, TY = T::TY, WY = T::WY, WZ = T::WZ;
  const int CS = cin_k + 8;  // window voxel stride: (CS / 8) odd keeps ldmatrix conflict-free
  const int KC = cin_k / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* normp = reinterpret_cast<float*>(smem);                                   // (4, cin_k)
  float* red = normp + 4 * cin_k;                                                  // (kWarps, 2, COUT)
  __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(red + kWarps * 2 * COUT);  // (WY, WZ, CS)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z, xo = blockIdx.y;
  const int nzb = (Zo + kTZ - 1) / kTZ;
  const int zo0 = (blockIdx.x % nzb) * kTZ;
  const int yo0 = (blockIdx.x / nzb) * TY;
  const int gy0 = S * yo0 - 1, gz0 = S * zo0 - 1;

  for (int i = tid; i < 4 * cin_k; i += kThreads) normp[i] = norm[(size_t)n * 4 * cin_k + i];

  float acc[MW][NT][4];
#pragma unroll
  for (int f = 0; f < MW; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  // shared-memory byte address of this lane's ldmatrix row (row a_row,
  // column a_col of a 16x16 A fragment) for each fragment at tap (0, 0, 0):
  // window y row S*ly, slot of input z S*zl (which is zl at both strides)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const uint32_t CS2 = (uint32_t)CS * 2;
  uint32_t abase[MW];
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    const int ly = warp * (MW / 2) + f / 2, zl = (f & 1) * 16 + a_row;
    abase[f] = static_cast<uint32_t>(__cvta_generic_to_shared(plane)) +
               (uint32_t)(S * ly * WZ + zl) * CS2 + a_col * 2;
  }
  const int c8k = cin_k / 8;
  const int units = WY * WZ * c8k;
  const bool vec = (cin & 7) == 0;
  const int steps = 9 * KC;  // (dy, dz, kc) per plane

  for (int dx = 0; dx < 3; ++dx) {
    const int gx = S * xo + dx - 1;
    if (gx < 0 || gx >= X) continue;  // block-uniform: an all-zero plane adds nothing
    __syncthreads();                  // the previous plane is consumed; normp is ready

    // --- stage the plane: 8 channels (16 bytes) per unit, norm + act in
    //     fp32, zero outside the volume and past cin, round to bf16. Each
    //     thread issues the loads of kBatch units before it uses any.
    const __nv_bfloat16* xp = x + ((size_t)n * X + gx) * Y * Z * cin;
    for (int u0 = tid; u0 < units; u0 += kBatch * kThreads) {
      uint4 raw[kBatch];
      int dst[kBatch];  // element offset in the plane, -1 past the units
      int ch[kBatch];   // first channel of the unit
      bool live[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int u = u0 + i * kThreads;
        raw[i] = make_uint4(0u, 0u, 0u, 0u);
        dst[i] = -1;
        ch[i] = 0;
        live[i] = false;
        if (u < units) {
          const int c0 = (u % c8k) * 8;
          const int r = u / c8k;
          const int iz = r % WZ, iy = r / WZ;
          const int gy = gy0 + iy, gz = gz0 + iz;
          ch[i] = c0;
          dst[i] = (iy * WZ + zslot<S>(iz, T::HALF)) * CS + c0;
          live[i] = gy >= 0 && gy < Y && gz >= 0 && gz < Z && c0 < cin;
          if (live[i]) {
            const __nv_bfloat16* src = xp + ((size_t)gy * Z + gz) * cin + c0;
            if (vec) {
              raw[i] = __ldg(reinterpret_cast<const uint4*>(src));
            } else {
              __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw[i]);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (c0 + j < cin) e[j] = src[j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (dst[i] < 0) continue;
        const uint4 v = live[i] ? act8(raw[i], normp, cin_k, ch[i])
                                : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(plane + dst[i]) = v;
      }
    }
    __syncthreads();

    // --- the plane's nine taps; B one step ahead
    const uint4* wq = wpk + (size_t)dx * steps * NB * 32 + lane;
    uint4 bn[NB];
#pragma unroll
    for (int p = 0; p < NB; ++p) bn[p] = __ldg(wq + p * 32);
    int ahead = steps - 1;  // steps whose B is still to load
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const uint32_t tap = (uint32_t)(dy * WZ + dz_slot<S>(dz, T::HALF)) * CS2;
        for (int kc = 0; kc < KC; ++kc) {
          uint4 b[NB];
#pragma unroll
          for (int p = 0; p < NB; ++p) b[p] = bn[p];
          if (ahead > 0) {
            wq += NB * 32;
#pragma unroll
            for (int p = 0; p < NB; ++p) bn[p] = __ldg(wq + p * 32);
            --ahead;
          }
          uint32_t a[MW][4];
#pragma unroll
          for (int f = 0; f < MW; ++f) ldmatrix_x4(a[f], abase[f] + tap + kc * 32);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t b0 = (j & 1) ? b[j / 2].z : b[j / 2].x;
            const uint32_t b1 = (j & 1) ? b[j / 2].w : b[j / 2].y;
#pragma unroll
            for (int f = 0; f < MW; ++f) mma_bf16(acc[f][j], a[f], b0, b1);
          }
        }
      }
    }
  }

  // --- epilogue: bias, store, per-channel sums over live voxels. Lane holds
  //     rows g and g + 8 of each fragment, columns 2t and 2t + 1 of each n8
  const int g = lane >> 2, t = lane & 3;
  float bv[NT][2], s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bv[j][e] = bias[j * 8 + 2 * t + e];
      s1[j][e] = 0.f;
      s2[j][e] = 0.f;
    }
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    const int yo = yo0 + warp * (MW / 2) + f / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int zo = zo0 + (f & 1) * 16 + g + 8 * h;
      if (yo < Yo && zo < Zo) {
        OutT* dst = y + ((((size_t)n * Xo + xo) * Yo + yo) * Zo + zo) * COUT + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float v0 = acc[f][j][2 * h] + bv[j][0];
          const float v1 = acc[f][j][2 * h + 1] + bv[j][1];
          store2(dst + j * 8, v0, v1);
          s1[j][0] += v0;
          s1[j][1] += v1;
          s2[j][0] += v0 * v0;
          s2[j][1] += v1 * v1;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], m);
        s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], m);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp * 2 * COUT + j * 8 + 2 * t + e] = s1[j][e];
        red[warp * 2 * COUT + COUT + j * 8 + 2 * t + e] = s2[j][e];
      }
  }
  __syncthreads();
  if (tid < 2 * COUT) {  // tid = which * COUT + channel, as in sums[n]
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * 2 * COUT + tid];
    atomicAdd(&sums[(size_t)n * 2 * COUT + tid], v);
  }
}

template <int S, int COUT, typename OutT>
int launch_rowconv(const void* x, const void* norm, const void* w, const void* bias, void* y,
                   void* sums, int N, int X, int Y, int Z, int cin, int cin_k, cudaStream_t st) {
  using T = Tile<S, COUT>;
  const int Xo = (X - 1) / S + 1, Yo = (Y - 1) / S + 1, Zo = (Z - 1) / S + 1;
  const size_t bytes = (size_t)4 * cin_k * 4 + (size_t)kWarps * 2 * COUT * 4 +
                       (size_t)T::WY * T::WZ * (cin_k + 8) * 2;
  auto kern = rowconv_kernel<S, COUT, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nzb = (Zo + kTZ - 1) / kTZ, nyb = (Yo + T::TY - 1) / T::TY;
  dim3 grid(nzb * nyb, Xo, N);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(norm),
      static_cast<const uint4*>(w), static_cast<const float*>(bias), static_cast<OutT*>(y),
      static_cast<float*>(sums), X, Y, Z, cin, cin_k, Xo, Yo, Zo);
  return (int)cudaGetLastError();
}

template <int S, typename OutT>
int dispatch_cout(const void* x, const void* norm, const void* w, const void* bias, void* y,
                  void* sums, int N, int X, int Y, int Z, int cin, int cin_k, int cout,
                  cudaStream_t st) {
  switch (cout) {
    case 16: return launch_rowconv<S, 16, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, cin_k, st);
    case 32: return launch_rowconv<S, 32, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, cin_k, st);
    case 64: return launch_rowconv<S, 64, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, cin_k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch (0 on success).
//   x     (N, X, Y, Z, cin) bf16, contiguous, any cin >= 1
//   norm  (N, 4, cin_k) float32 rows [mean, inv_std * gamma, beta, slope],
//         cin_k = round_up(cin, 16); channels past cin need scale 0
//   w     B fragments: for tap = (dx*3 + dy)*3 + dz, kc < cin_k/16,
//         p < cout/16, lane = 4g + t, the 16 bytes at index
//         ((tap*(cin_k/16) + kc)*(cout/16) + p)*32 + lane hold the bf16
//         values w[tap, kc*16 + 8h + 2t + e, p*16 + 8q + g] in (q, h, e) order
//   bias  (cout,) float32;  y (N, Xo, Yo, Zo, cout);  sums (N, 2, cout) float32,
//         zeroed by the caller; cout one of 16/32/64; stride 1 or 2
extern "C" int boa_rowconv_fwd(const void* x, const void* norm, const void* w, const void* bias,
                               void* y, void* sums, int N, int X, int Y, int Z, int cin,
                               int cin_k, int cout, int stride, int out_f32, void* stream) {
  if (cin < 1 || cin_k % 16 != 0 || cin_k < cin || cin_k >= cin + 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride == 1)
    return out_f32 ? dispatch_cout<1, float>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, cin_k, cout, st)
                   : dispatch_cout<1, __nv_bfloat16>(x, norm, w, bias, y, sums, N, X, Y, Z, cin,
                                                     cin_k, cout, st);
  if (stride == 2)
    return out_f32 ? dispatch_cout<2, float>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, cin_k, cout, st)
                   : dispatch_cout<2, __nv_bfloat16>(x, norm, w, bias, y, sums, N, X, Y, Z, cin,
                                                     cin_k, cout, st);
  return (int)cudaErrorInvalidValue;
}
