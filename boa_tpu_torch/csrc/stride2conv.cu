// Fused 3x3x3 stride-2 conv (padding 1) with input-side instance-norm +
// LeakyReLU and per-channel output sums, for Hopper (sm_90a), bf16 in, fp32
// accumulate, channels-last.
//
// Replaces: boa_tpu/ops/rowconv.py `_stride2_kernel`, the encoder's first
// downsample (stage 0 -> stage 1). Contract, per sample n, input channel ci
// and output channel co:
//   act(x)  = LeakyReLU_s((x - mean) * scale + beta), scale = inv_std*gamma,
//             s a per-channel slope (1 = identity), zero outside the volume
//             AFTER act (torch pads the normalized tensor with zeros)
//   y[o]    = bias + sum_{d, ci} w[d, ci, co] * act(x)[2o + d - 1]
//   sums    += (sum y, sum y^2) over live output voxels, from fp32 values
// Rounding points as in rowconv.cu. The input's voxels lie ldx elements
// apart (ldx >= cin), so x can be a channel slice of a wider buffer (the
// skip half of the decoder concat).
//
// What bounds it on an H100: at the main path's shape (128^3 x 32 ->
// 64^3 x 64) it reads 134 MB and writes 34 MB for 29 GFLOP: 0.050 ms at the
// memory line against 0.029 ms at the bf16 tensor-core peak, so both matter,
// and every input voxel feeds only 27/8 multiply-adds per output channel:
// staging (load, norm + act, store) is as heavy as the products. The design
// stages each input voxel once and overlaps its load with the products:
//
// A block of 4 warps owns an 8 (y) x 16 (z) output tile (4 x 16 at cin 64)
// and walks a column of tx consecutive output x planes. Output plane xo
// reads input planes 2xo - 1, 2xo, 2xo + 1, and plane 2xo + 1 opens plane
// xo + 1 as well, so the block stages 2 * tx + 1 input planes, each once:
// the odd plane stays in shared memory across the epilogue of xo. Each
// plane's haloed window (17 y x 33 z voxels) lands raw through cp.async
// (16 bytes, L2 only) straight into its place in one of two plane buffers,
// while the previous plane is normalized and multiplied out of the other.
// The layout is the one `ldmatrix` reads conflict-free: channels innermost
// with a voxel stride of cin + 8, z slots even-first, odd-second, so that
// the 16 stride-2 rows of an A fragment are 16 consecutive slots. Norm + act
// then run in place, once per staged value, in fp32; each thread stages one
// fixed 8-channel chunk and keeps its norm rows in registers, so the staging
// loops read no norm rows and carry no divisions by the channel count. Each
// warp holds two A fragments (two output y rows x 16 z) against all cout
// columns and multiplies with `mma.sync` m16n8k16; B fragments are packed by
// the wrapper in per-lane register order and read with coalesced 16-byte
// loads, one k step ahead. Two blocks share an SM, so one block's staging
// overlaps the other's products. The epilogue of each output plane adds the
// fp32 bias, rounds, and writes y through a small per-warp staging buffer
// in whole 16-byte pieces; the per-channel sums stay in registers over the
// column and leave with one atomicAdd per channel and block. The column
// length tx is chosen at launch from the waves of blocks it gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using boa::act8;
using boa::load_norm8;
using boa::cp_async16;
using boa::cp_async_commit;
using boa::cp_async_wait;
using boa::ldmatrix_x4;
using boa::mma_bf16;
using boa::store2;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTZ = 16;               // output z per tile: one 16-row A fragment
constexpr int kWZ = 2 * kTZ + 1;      // window z voxels
constexpr int kHalf = (kWZ + 1) / 2;  // even z slots come first

// Tile geometry for CIN (padded) input channels: two plane buffers must fit
// the 227 KB of shared memory a block can have (at cin 64 one block per SM).
template <int CIN>
struct Geo {
  static constexpr int MW = CIN <= 32 ? 2 : 1;  // A fragments per warp: output y rows
  static constexpr int TY = kWarps * MW;         // output y per tile
  static constexpr int WY = 2 * TY + 1;          // window y rows
  static constexpr int VOX = WY * kWZ;           // window voxels
  static constexpr int CS = CIN + 8;  // voxel stride: (CS / 8) odd keeps ldmatrix conflict-free
};

// output staging row: one voxel's COUT channels, padded by 16 bytes
template <int COUT, typename OutT>
__host__ __device__ constexpr int stage_row() {
  return COUT * (int)sizeof(OutT) + 16;
}

template <int CIN, int COUT, typename OutT>
size_t smem_bytes() {
  return (size_t)kWarps * 2 * COUT * 4 + (size_t)kWarps * 16 * stage_row<COUT, OutT>() +
         (size_t)2 * Geo<CIN>::VOX * Geo<CIN>::CS * 2;
}

template <int CIN, int COUT, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    stride2_kernel(const __nv_bfloat16* __restrict__ x,  // (N, X, Y, Z) voxels, ldx apart
                   const float* __restrict__ norm,       // (N, 4, CIN)
                   const uint4* __restrict__ wpk,        // B fragments, see boa_stride2conv_fwd
                   const float* __restrict__ bias,       // (COUT,)
                   OutT* __restrict__ y,                 // (N, Xo, Yo, Zo, COUT)
                   float* __restrict__ sums,             // (N, 2, COUT)
                   int X, int Y, int Z, int cin, int ldx, int Xo, int Yo, int Zo, int tx) {
  using G = Geo<CIN>;
  constexpr int MW = G::MW, TY = G::TY, VOX = G::VOX, CS = G::CS;
  constexpr int NT = COUT / 8, NB = NT / 2, KC = CIN / 16;
  constexpr int C8 = CIN / 8;  // 16-byte chunks per voxel; thread tid stages chunk tid % C8
  constexpr int VSTEP = kThreads / C8;
  static_assert(kThreads % C8 == 0, "a thread's channel chunk must stay fixed");

  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RS = stage_row<COUT, OutT>();
  constexpr int VEC = COUT * (int)sizeof(OutT) / 16;  // 16-byte stores per output voxel
  float* red = reinterpret_cast<float*>(smem);        // (kWarps, 2, COUT)
  unsigned char* ostage = smem + kWarps * 2 * COUT * 4;  // (kWarps, 16, RS)
  // two plane buffers of (WY, kWZ slots, CS), kPlane elements each
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(ostage + kWarps * 16 * RS);
  constexpr int kPlane = VOX * CS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int nzb = (Zo + kTZ - 1) / kTZ;
  const int zo0 = (blockIdx.x % nzb) * kTZ, yo0 = (blockIdx.x / nzb) * TY;
  const int xo0 = blockIdx.y * tx;
  const int nx = min(tx, Xo - xo0);
  const int gy0 = 2 * yo0 - 1, gz0 = 2 * zo0 - 1;
  const int ch = (tid % C8) * 8;  // this thread's staging chunk
  const int v0 = tid / C8;

  const boa::Norm8 nrm = load_norm8(norm + (size_t)n * 4 * CIN, CIN, ch);  // this chunk's norm

  // window voxel (iy, iz) of this thread's chunk, in a plane buffer
  auto at = [&](__nv_bfloat16* buf, int iy, int iz) {
    return buf + (iy * kWZ + ((iz & 1) ? kHalf + (iz >> 1) : (iz >> 1))) * CS + ch;
  };
  // raw window of input plane gx into `buf`: one 16-byte cp.async per live
  // (voxel, chunk)
  auto fetch = [&](int gx, __nv_bfloat16* buf) {
    const __nv_bfloat16* xp = x + ((size_t)n * X + gx) * Y * Z * ldx + ch;
    if (ch >= cin) return;
    for (int v = v0; v < VOX; v += VSTEP) {
      const int iy = v / kWZ, iz = v - iy * kWZ;
      const int gy = gy0 + iy, gz = gz0 + iz;
      if (gy >= 0 && gy < Y && gz >= 0 && gz < Z)
        cp_async16(at(buf, iy, iz), xp + ((size_t)gy * Z + gz) * ldx);
    }
  };

  float acc[MW][NT][4];
#pragma unroll
  for (int f = 0; f < MW; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[j][e] = s2[j][e] = 0.f;

  // ldmatrix row address of each fragment at tap (dy, dz) = (0, 0): output
  // y row ly reads window row 2*ly + dy, output z zl reads slot zl (dz = 0),
  // kHalf + zl (dz = 1) or zl + 1 (dz = 2)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  uint32_t abase[MW];
#pragma unroll
  for (int f = 0; f < MW; ++f)
    abase[f] = static_cast<uint32_t>(__cvta_generic_to_shared(planes)) +
               (uint32_t)((2 * (warp * MW + f) * kWZ + a_row) * CS + a_col) * 2;

  // the nine (dy, dz) taps of tap plane dx, out of plane buffer `buf`
  // the nine (dy, dz) taps of tap plane dx, out of plane buffer `buf`: 9 * KC
  // k steps, each step's A and B fragments loaded one step ahead of its
  // products (the asm of ldmatrix and mma is volatile, so the compiler keeps
  // the order written here)
  auto products = [&](int dx, int buf) {
    constexpr int STEPS = 9 * KC;
    const uint32_t boff = (uint32_t)(buf * kPlane) * 2;
    const uint4* wq = wpk + (size_t)dx * STEPS * NB * 32 + lane;
    auto load = [&](int step, uint32_t (&a)[MW][4], uint4 (&b)[NB]) {
      const int tap9 = step / KC, kc = step % KC, dy = tap9 / 3, dz = tap9 % 3;
      const uint32_t tap = (uint32_t)((dy * kWZ + (dz == 1 ? kHalf : dz / 2)) * CS) * 2;
#pragma unroll
      for (int p = 0; p < NB; ++p) b[p] = __ldg(wq + (step * NB + p) * 32);
#pragma unroll
      for (int f = 0; f < MW; ++f) ldmatrix_x4(a[f], abase[f] + boff + tap + kc * 32);
    };
    uint32_t a[2][MW][4];
    uint4 b[2][NB];
    load(0, a[0], b[0]);
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      const int cur = step & 1;
      if (step + 1 < STEPS) load(step + 1, a[cur ^ 1], b[cur ^ 1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t b0 = (j & 1) ? b[cur][j / 2].z : b[cur][j / 2].x;
        const uint32_t b1 = (j & 1) ? b[cur][j / 2].w : b[cur][j / 2].y;
#pragma unroll
        for (int f = 0; f < MW; ++f) mma_bf16(acc[f][j], a[cur][f], b0, b1);
      }
    }
  };

  // bias, store and sums of output plane xo; lane holds rows g, g + 8 and
  // columns 2t, 2t + 1 of each fragment's n8 tiles
  const int g = lane >> 2, t = lane & 3;
  // Each fragment (one output y row x 16 z) goes through the warp's staging
  // rows, so that the stores are whole 16-byte pieces of consecutive voxels.
  unsigned char* st = ostage + warp * 16 * RS;
  auto epilogue = [&](int xo) {
#pragma unroll
    for (int f = 0; f < MW; ++f) {
      const int yo = yo0 + warp * MW + f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool live = yo < Yo && zo0 + g + 8 * h < Zo;
        OutT* row = reinterpret_cast<OutT*>(st + (g + 8 * h) * RS) + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float v0 = acc[f][j][2 * h] + bias[j * 8 + 2 * t];
          const float v1 = acc[f][j][2 * h + 1] + bias[j * 8 + 2 * t + 1];
          store2(row + j * 8, v0, v1);
          if (live) {
            s1[j][0] += v0;
            s1[j][1] += v1;
            s2[j][0] += v0 * v0;
            s2[j][1] += v1 * v1;
          }
          acc[f][j][2 * h] = acc[f][j][2 * h + 1] = 0.f;
        }
      }
      __syncwarp();
      if (yo < Yo) {
        OutT* dst = y + (((size_t)n * Xo + xo) * Yo + yo) * Zo * COUT;
#pragma unroll
        for (int u = lane; u < 16 * VEC; u += 32) {
          const int r = u / VEC, q = u % VEC;
          if (zo0 + r < Zo)
            *reinterpret_cast<uint4*>(dst + (size_t)(zo0 + r) * COUT + q * (16 / (int)sizeof(OutT))) =
                *reinterpret_cast<const uint4*>(st + r * RS + q * 16);
        }
      }
      __syncwarp();
    }
  };

  const int nplanes = 2 * nx + 1;  // input planes 2*xo0 - 1 + k, k < nplanes
  auto live_plane = [&](int k) {
    const int gx = 2 * xo0 - 1 + k;
    return gx >= 0 && gx < X;
  };
  if (live_plane(0)) fetch(2 * xo0 - 1, planes);
  cp_async_commit();

  for (int k = 0; k < nplanes; ++k) {
    const bool live = live_plane(k);
    __nv_bfloat16* buf = planes + (k & 1) * kPlane;
    __syncthreads();  // plane k - 1's products are done: its buffer is free
    if (k + 1 < nplanes && live_plane(k + 1)) fetch(2 * xo0 + k, planes + ((k + 1) & 1) * kPlane);
    cp_async_commit();
    cp_async_wait<1>();  // plane k landed (plane k + 1 may still be in flight)
    __syncthreads();
    if (live) {  // norm + act in place (zero outside the volume and past cin)
      for (int v = v0; v < VOX; v += VSTEP) {
        const int iy = v / kWZ, iz = v - iy * kWZ;
        const int gy = gy0 + iy, gz = gz0 + iz;
        uint4* p = reinterpret_cast<uint4*>(at(buf, iy, iz));
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < Y && gz >= 0 && gz < Z && ch < cin) o = act8(*p, nrm);
        *p = o;
      }
    }
    __syncthreads();  // activations ready
    // plane k is tap dx = 0 of xo0 (k = 0), dx = 1 (k odd) or dx = 2 (k even)
    // of xo0 + (k - 1) / 2; an even k >= 2 closes that plane and opens the next
    if (live) products(k == 0 ? 0 : ((k & 1) ? 1 : 2), k & 1);
    if (k >= 2 && !(k & 1)) {
      epilogue(xo0 + k / 2 - 1);
      if (live && k + 1 < nplanes) products(0, k & 1);
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

template <int CIN, int COUT, typename OutT>
int launch_stride2(const void* x, const void* norm, const void* w, const void* bias, void* y,
                   void* sums, int N, int X, int Y, int Z, int cin, int ldx, cudaStream_t st) {
  const int Xo = (X + 1) / 2, Yo = (Y + 1) / 2, Zo = (Z + 1) / 2;
  const size_t bytes = smem_bytes<CIN, COUT, OutT>();
  auto kern = stride2_kernel<CIN, COUT, OutT>;
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
  const long long tiles =
      (long long)((Yo + Geo<CIN>::TY - 1) / Geo<CIN>::TY) * ((Zo + kTZ - 1) / kTZ) * N;
  // column length: a block's time grows with the 2 * tx + 1 planes it
  // stages, the kernel's with the waves of blocks over the card's block slots
  const long long slots = (long long)sms * per_sm;
  int tx = 1;
  long long best = -1;
  for (int c = 1; c <= 16; c *= 2) {
    const long long waves = (tiles * ((Xo + c - 1) / c) + slots - 1) / slots;
    const long long cost = waves * (2 * c + 1);
    if (best < 0 || cost < best) best = cost, tx = c;
  }
  dim3 grid((unsigned)(tiles / N), (unsigned)((Xo + tx - 1) / tx), (unsigned)N);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(norm),
      static_cast<const uint4*>(w), static_cast<const float*>(bias), static_cast<OutT*>(y),
      static_cast<float*>(sums), X, Y, Z, cin, ldx, Xo, Yo, Zo, tx);
  return (int)cudaGetLastError();
}

template <int CIN, typename OutT>
int dispatch_cout(const void* x, const void* norm, const void* w, const void* bias, void* y,
                  void* sums, int N, int X, int Y, int Z, int cin, int ldx, int cout,
                  cudaStream_t st) {
  switch (cout) {
    case 16: return launch_stride2<CIN, 16, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, ldx, st);
    case 32: return launch_stride2<CIN, 32, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, ldx, st);
    case 64: return launch_stride2<CIN, 64, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, ldx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename OutT>
int dispatch(const void* x, const void* norm, const void* w, const void* bias, void* y,
             void* sums, int N, int X, int Y, int Z, int cin, int cin_k, int ldx, int cout,
             cudaStream_t st) {
  switch (cin_k) {
    case 16: return dispatch_cout<16, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, ldx, cout, st);
    case 32: return dispatch_cout<32, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, ldx, cout, st);
    case 64: return dispatch_cout<64, OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, ldx, cout, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch (0 on success).
//   x     (N, X, Y, Z, cin) bf16 with voxel stride ldx (element
//         ((n*X + x)*Y + y)*Z + z times ldx holds the voxel's cin channels);
//         16-byte aligned, cin and ldx multiples of 8, cin <= cin_k
//   norm  (N, 4, cin_k) float32 rows [mean, inv_std * gamma, beta, slope],
//         cin_k one of 16/32/64; channels past cin need scale 0
//   w     B fragments as in boa_rowconv_fwd (tap = (dx*3 + dy)*3 + dz)
//   bias  (cout,) float32;  y (N, Xo, Yo, Zo, cout) contiguous, Xo = ceil(X/2)
//         etc.;  sums (N, 2, cout) float32, zeroed by the caller;
//         cout one of 16/32/64
extern "C" int boa_stride2conv_fwd(const void* x, const void* norm, const void* w,
                                   const void* bias, void* y, void* sums, int N, int X, int Y,
                                   int Z, int cin, int cin_k, int ldx, int cout, int out_f32,
                                   void* stream) {
  if (cin < 8 || cin % 8 != 0 || cin > cin_k || ldx < cin || ldx % 8 != 0 || N < 1 || X < 1 ||
      Y < 1 || Z < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<float>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, cin_k, ldx, cout, st)
                 : dispatch<__nv_bfloat16>(x, norm, w, bias, y, sums, N, X, Y, Z, cin, cin_k, ldx,
                                           cout, st);
}
