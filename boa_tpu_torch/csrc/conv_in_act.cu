// Fused 3x3x3 'same' conv with input-side instance-norm + LeakyReLU and
// per-sample, per-channel output sums, for Hopper (sm_90a): bf16 in, fp32
// accumulate, a batch of N samples.
//
// Replaces: boa_tpu/ops/pallas_conv.py `_conv_kernel` (K5), the kernel of
// `conv3d_in_act`, which the fused U-Net forward runs for every stride-1
// 3x3x3 conv block; and boa_tpu/ops/rowconv.py `_rowconv_kernel` (K1) and
// `_rowconv_g4_kernel` (K4, the same function with four output rows packed
// for the TPU matrix unit), the stride-1 convs of the composite forward
// (`ops/rowconv.py:conv3d_rows`). The stride-2 conv is stride2conv.cu.
// Contract, per sample n, input channel ci and output channel co:
//   act(x)  = LeakyReLU_s((x - mean) * scale + beta), scale = inv_std*gamma,
//             s a per-channel slope (1 = identity), zero outside the volume
//             AFTER act (torch pads the normalized tensor with zeros)
//   y[o]    = bias + sum_{d, ci} w[d, ci, co] * act(x)[o + d - 1]
//   sums[n] += (sum y, sum y^2) over live output voxels, from fp32 values
// Rounding points follow the reference: x arrives in bf16, the norm runs in
// fp32, act is rounded to bf16 for the tensor cores, the weights are bf16,
// the accumulator and the bias are fp32, y is stored in bf16 or fp32. Each
// output voxel's channels are contiguous and the voxels ldy elements apart,
// so y can be a channel slice of a wider buffer (the decoder concat).
//
// What bounds it on an H100: at the fused forward's shapes (128^3 down to
// 4^3 voxels, cin 1..640, cout 32..320) and at the composite's 128^3 calls
// (cin 32 or 64, cout 32: 116-232 GFLOP against 0.27-0.4 GB) every call but
// the 1-channel input conv does 100-4000 FLOP per compulsory byte, so it is
// bound by the bf16 tensor cores (989 TFLOP/s), not by the 3.35 TB/s memory;
// the 8^3 and 4^3 calls are too small to fill 132 SMs at all. The input
// conv (cin = 1) is bound by the bytes of its 128^3 x 32 bf16 output. The
// design keeps the tensor cores fed from on-chip memory, at any width:
//
// An implicit GEMM with M = output voxels, N = cout and K = 27 * cin. A block
// of 8 warps owns a brick of 4 x TY x 16 output voxels (TY = 4 or 8) of one
// sample and one tile of BN = 64 output channels (32 when cout <= 32); N
// tiles run on the grid's y axis, so cout 320 is five tiles. K is walked in
// chunks of CK = 32 input channels (16 when cin <= 16): each chunk's haloed
// window (6 x (TY+2) x 18 voxels) is staged into shared memory with norm +
// act applied on the way, so the halo is zero after act and normalized
// activations never touch device memory; then all 27 taps of the chunk are
// multiplied out of it. A brick of 4 output x rows stages 6 window planes,
// about 2 loads of each input voxel. Chunking bounds the window at any cin
// (the 640-wide decoder concat is 20 chunks). The window keeps channels
// innermost with a voxel stride of CK + 8, so the 16 output z of one A
// fragment are 16 shared-memory rows that `ldmatrix` reads without bank
// conflicts. Each warp holds MW A fragments against the block's BN columns
// (64 fp32 accumulators a thread) and multiplies with `mma.sync` m16n8k16. B
// fragments are packed by the wrapper in the exact per-lane register order,
// chunk-major per N tile, so a warp reads them with coalesced 16-byte loads
// that the block's eight warps share through L1. Padded input channels have
// scale 0 (their act is 0) and zero weights. The epilogue adds the fp32
// bias, stores y from registers and reduces sum/sum^2 with warp shuffles and
// shared memory before one atomicAdd per channel and block. Two blocks share
// an SM (at most 128 registers a thread), so one block's staging overlaps
// the other's products. The sample index is folded into the grid's z axis
// and enters the addresses as a row offset computed once per block.
//
// The 1-channel input conv (CK = 1, `conv1_kernel`) folds the 27 taps into
// K instead: K = 27 taps padded to 32, two k16 steps per A fragment where a
// 16-channel chunk would take 27. It stages the 1-channel window with norm
// + act; each lane gathers its A values (row = output z, k = tap) from the
// window at per-lane tap offsets fixed for the block, and holds the whole
// (32, BN) B tile in registers. Padded taps (k >= 27) have zero weights and
// read tap 0's value, which the output already depends on.
//
// Split-K. The calls at 16^3 and below have 5-64 bricks x N tiles, too few
// blocks for 132 SMs, and each block would walk all of K alone. The grid's
// z axis (blockIdx.z = n * splits + k) splits K: the wrapper
// (`ops/pallas_conv.py:_split_plan`) cuts the K units (the chunks, or chunk
// x dx tap plane when chunks alone give too few blocks, as the 4^3 call's 10
// chunks do) into `splits` contiguous ranges, about two blocks per SM in
// all. A split stages only the window planes its dx range reads. With
// splits > 1 each split stores its raw fp32 accumulators (no bias) with
// plain stores into its own slice of a workspace (N, splits, X*Y*Z, cout_p),
// and `finish_kernel` sums the slices in a fixed order, adds the bias once,
// rounds once, stores y and reduces the sums from those fp32 values: y is
// bitwise the same from run to run. With splits = 1 the fused epilogue above
// stays, with no workspace and no second launch. Tried and dropped: a
// double-buffered window (the next chunk's raw window by cp.async while the
// current one multiplies, norm + act in place) gained 1-5 % at 64^3 and 32^3
// and lost 10 % on a 16^3 split call: two blocks per SM already overlap
// one's staging with the other's products. Not done yet (later work):
// weights in shared memory, wgmma + TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using boa::act8;
using boa::ldmatrix_x4;
using boa::mma_bf16;
using boa::store2;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTX = 4;     // output x per brick
constexpr int kTZ = 16;    // output z per brick: one 16-row A fragment
constexpr int kWX = kTX + 2, kWZ = kTZ + 2;
constexpr int kBatch = 4;  // staging units whose loads a thread keeps in flight

// Brick geometry for a BN-column tile: 64 accumulators a thread either way.
template <int BN>
struct Brick {
  static constexpr int NT = BN / 8;             // n8 column tiles
  static constexpr int NB = BN / 16;            // 16-byte B loads per lane and k step
  static constexpr int MW = 16 / NT;            // A fragments per warp
  static constexpr int TY = kWarps * MW / kTX;  // output y per brick
  static constexpr int WY = TY + 2;             // window y rows
};

// The brick of output voxels that block `bx` of the grid's x axis owns.
template <int BN>
__device__ __forceinline__ void brick_origin(int bx, int Y, int Z, int& x0, int& y0, int& z0) {
  const int nzb = (Z + kTZ - 1) / kTZ, nyb = (Y + Brick<BN>::TY - 1) / Brick<BN>::TY;
  z0 = (bx % nzb) * kTZ;
  y0 = (bx / nzb % nyb) * Brick<BN>::TY;
  x0 = (bx / nzb / nyb) * kTX;
}

// The fused epilogue of an unsplit call: bias, y stored from registers
// (voxels ldy apart), per-channel sum/sum^2 over live voxels reduced with
// warp shuffles and shared memory `red` (kWarps, 2, BN), one atomicAdd per
// channel and block. Lane holds rows g and g + 8 of each fragment, columns
// 2t and 2t + 1 of each n8 tile. The block's sample n is xn = n * X rows
// into y; sums points at its sums.
template <int BN, typename OutT>
__device__ __forceinline__ void fused_epilogue(float (&acc)[Brick<BN>::MW][Brick<BN>::NT][4],
                                               const float* __restrict__ bias,
                                               OutT* __restrict__ y, float* __restrict__ sums,
                                               float* red, int X, int Y, int Z, int xn, int x0,
                                               int y0, int z0, int nb, int cout_p, int ldy) {
  using B = Brick<BN>;
  constexpr int MW = B::MW, NT = B::NT, TY = B::TY;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = nb * BN + 2 * t;
  float bv[NT][2], s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bv[j][e] = bias[col0 + j * 8 + e];
      s1[j][e] = 0.f;
      s2[j][e] = 0.f;
    }
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    const int r = warp * MW + f;
    const int gx = x0 + r / TY, gy = y0 + r % TY;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gz = z0 + g + 8 * h;
      if (gx < X && gy < Y && gz < Z) {
        OutT* dst = y + (((size_t)(xn + gx) * Y + gy) * Z + gz) * ldy + col0;
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
        red[warp * 2 * BN + j * 8 + 2 * t + e] = s1[j][e];
        red[warp * 2 * BN + BN + j * 8 + 2 * t + e] = s2[j][e];
      }
  }
  __syncthreads();
  if (tid < 2 * BN) {  // tid = which * BN + column of the tile
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * 2 * BN + tid];
    atomicAdd(&sums[(tid / BN) * cout_p + nb * BN + tid % BN], v);
  }
}

// SPLIT: the grid's z axis splits K and the epilogue stores raw partial
// sums; without it the kernel walks all of K and runs the fused epilogue,
// and compiles as if the split arguments were not there.
template <int BN, int CK, typename OutT, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2)  // 2 blocks per SM: at most 128 registers
    conv_in_act_kernel(const __nv_bfloat16* __restrict__ x,  // (N, X, Y, Z, cin)
                       const float* __restrict__ norm,       // (N, 4, nchunks * CK)
                       const uint4* __restrict__ wpk,        // B fragments, see boa_conv_in_act_fwd
                       const float* __restrict__ bias,       // (cout_p,)
                       OutT* __restrict__ y,                 // (N, X, Y, Z) voxels, ldy apart
                       float* __restrict__ sums,             // (N, 2, cout_p)
                       float* __restrict__ ws,               // (N, splits, X*Y*Z, cout_p)
                       int X, int Y, int Z, int cin, int nchunks, int cout_p, int ldy,
                       int splits, int taps) {
  using B = Brick<BN>;
  constexpr int MW = B::MW, NT = B::NT, NB = B::NB, TY = B::TY, WY = B::WY;
  constexpr int CS = CK + 8;  // window voxel stride: (CS / 8) odd keeps ldmatrix conflict-free
  constexpr int KS = CK / 16;  // k16 steps per chunk and tap
  constexpr int C8 = CK / 8;   // 16-byte staging units per voxel and chunk
  constexpr int PLANE = WY * kWZ;              // window voxels per x plane
  constexpr int TAP_B = KS * NB * 32;          // uint4 of B per tap, chunk and N tile
  constexpr int CHUNK_B = 27 * TAP_B;
  const int cin_k = nchunks * CK;

  extern __shared__ __align__(16) unsigned char smem[];
  float* normp = reinterpret_cast<float*>(smem);                                 // (4, cin_k)
  float* red = normp + 4 * cin_k;                                                // (kWarps, 2, BN)
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(red + kWarps * 2 * BN);  // (kWX, WY, kWZ, CS)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int x0, y0, z0;
  brick_origin<BN>(blockIdx.x, Y, Z, x0, y0, z0);
  const int nb = blockIdx.y;
  // sample n and split kz of this block: blockIdx.z = n * splits + kz. The
  // sample enters the addresses as xn = n * X rows of x (one register where
  // an offset pointer would hold two across the chunk loop).
  const int n = SPLIT ? blockIdx.z / splits : blockIdx.z;
  const int kz = SPLIT ? blockIdx.z - n * splits : 0;
  const int xn = n * X;
  norm += (size_t)n * 4 * cin_k;
  // this split's K units [ku0, ku1): unit u is chunk u / taps and, with
  // taps = 3, its dx tap plane u % 3
  if (!SPLIT) taps = 1;
  const int nunits = nchunks * taps;
  const int ku0 = SPLIT ? kz * nunits / splits : 0;
  const int ku1 = SPLIT ? (kz + 1) * nunits / splits : nunits;

  for (int i = tid; i < 4 * cin_k; i += kThreads) normp[i] = norm[i];

  float acc[MW][NT][4];
#pragma unroll
  for (int f = 0; f < MW; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  // shared-memory byte address of this lane's ldmatrix row (row a_row,
  // column a_col of a 16x16 A fragment) for each fragment at tap (0, 0, 0).
  // Fragment f of warp w is the output (x, y) row r = w * MW + f of the
  // brick; its 16 rows are the brick's 16 output z.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  uint32_t abase[MW];
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    const int r = warp * MW + f, lx = r / TY, ly = r % TY;
    abase[f] = static_cast<uint32_t>(__cvta_generic_to_shared(win)) +
               (uint32_t)(((lx * WY + ly) * kWZ + a_row) * CS + a_col) * 2;
  }
  const bool vec = (cin & 7) == 0;
  const uint4* wblk = wpk + (size_t)nb * nchunks * CHUNK_B + lane;

  for (int c = ku0 / taps; c * taps < ku1; ++c) {
    // dx tap planes [dx0, dx1) of this chunk, and the window x planes
    // [dx0, dx1 + kTX - 1) that they read
    const int dx0 = SPLIT ? (max(ku0, c * taps) - c * taps) * 3 / taps : 0;
    const int dx1 = SPLIT ? (min(ku1, (c + 1) * taps) - c * taps) * 3 / taps : 3;
    const int units = (dx1 - dx0 + kTX - 1) * PLANE * C8;
    __syncthreads();  // the previous chunk is consumed; normp is ready

    // --- stage the chunk's window: 8 channels (16 bytes) per unit, norm +
    //     act in fp32, zero outside the volume and past cin, round to bf16.
    //     Each thread issues the loads of kBatch units before it uses any.
    const int cbase = c * CK;
    const int vbase = dx0 * PLANE;  // first staged window voxel
    for (int u0 = tid; u0 < units; u0 += kBatch * kThreads) {
      uint4 raw[kBatch];
      int ch[kBatch];  // first channel of the unit, -1 past the units
      bool live[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int u = u0 + i * kThreads;
        raw[i] = make_uint4(0u, 0u, 0u, 0u);
        ch[i] = -1;
        live[i] = false;
        if (u < units) {
          const int v = vbase + u / C8;  // window voxel, (ix, iy, iz) row-major
          const int iz = v % kWZ, iy = v / kWZ % WY, ix = v / kWZ / WY;
          const int gx = x0 - 1 + ix, gy = y0 - 1 + iy, gz = z0 - 1 + iz;
          ch[i] = cbase + (u % C8) * 8;
          live[i] = gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z && ch[i] < cin;
          if (live[i]) {
            const __nv_bfloat16* src = x + (((size_t)(xn + gx) * Y + gy) * Z + gz) * cin + ch[i];
            if (vec) {
              raw[i] = __ldg(reinterpret_cast<const uint4*>(src));
            } else {
              __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw[i]);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (ch[i] + j < cin) e[j] = src[j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (ch[i] < 0) continue;
        const int u = u0 + i * kThreads;
        const uint4 v = live[i] ? act8(raw[i], normp, cin_k, ch[i]) : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(win + (vbase + u / C8) * CS + (u % C8) * 8) = v;
      }
    }
    __syncthreads();

    // --- the chunk's taps in [dx0, dx1) x 9 x KS k steps
    const uint4* wq = wblk + (size_t)c * CHUNK_B + dx0 * 9 * TAP_B;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      if (dx < dx0 || dx >= dx1) continue;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          constexpr uint32_t CS2 = CS * 2;
          const uint32_t tap = (uint32_t)((dx * WY + dy) * kWZ + dz) * CS2;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint4 b[NB];
#pragma unroll
            for (int p = 0; p < NB; ++p) b[p] = __ldg(wq + p * 32);
            wq += NB * 32;
            uint32_t a[MW][4];
#pragma unroll
            for (int f = 0; f < MW; ++f) ldmatrix_x4(a[f], abase[f] + tap + ks * 32);
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

  if (SPLIT) {  // raw partial sums into this split's workspace slice
    const int g = lane >> 2, t = lane & 3;
    const int col0 = nb * BN + 2 * t;
    float* wsk = ws + (size_t)blockIdx.z * X * Y * Z * cout_p;
#pragma unroll
    for (int f = 0; f < MW; ++f) {
      const int r = warp * MW + f;
      const int gx = x0 + r / TY, gy = y0 + r % TY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gz = z0 + g + 8 * h;
        if (gx < X && gy < Y && gz < Z) {
          float* dst = wsk + (((size_t)gx * Y + gy) * Z + gz) * cout_p + col0;
#pragma unroll
          for (int j = 0; j < NT; ++j) store2(dst + j * 8, acc[f][j][2 * h], acc[f][j][2 * h + 1]);
        }
      }
    }
    return;
  }
  fused_epilogue<BN, OutT>(acc, bias, y, sums + (size_t)blockIdx.z * 2 * cout_p, red, X, Y, Z,
                           xn, x0, y0, z0, nb, cout_p, ldy);  // unsplit: n = blockIdx.z
}

// The input conv, cin = 1, with the 27 taps folded into K (see the note at
// the head of the file). One 32-column N tile per block.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    conv1_kernel(const __nv_bfloat16* __restrict__ x,  // (N, X, Y, Z), one channel
                 const float* __restrict__ norm,       // (N, 4, 1)
                 const uint4* __restrict__ wpk,        // B fragments, see boa_conv_in_act_fwd
                 const float* __restrict__ bias,       // (cout_p,)
                 OutT* __restrict__ y,                 // (N, X, Y, Z) voxels, ldy apart
                 float* __restrict__ sums,             // (N, 2, cout_p)
                 int X, int Y, int Z, int cout_p, int ldy) {
  using B = Brick<32>;
  constexpr int MW = B::MW, NT = B::NT, NB = B::NB, TY = B::TY, WY = B::WY;
  constexpr int WIN = kWX * WY * kWZ;                 // window voxels
  constexpr int PER = (WIN + kThreads - 1) / kThreads;  // window voxels a thread stages
  __shared__ uint16_t win[WIN];  // bf16 bits
  __shared__ float red[kWarps * 2 * 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int x0, y0, z0;
  brick_origin<32>(blockIdx.x, Y, Z, x0, y0, z0);
  const int nb = blockIdx.y, n = blockIdx.z, xn = n * X;
  const float mean = norm[4 * n], scale = norm[4 * n + 1], beta = norm[4 * n + 2],
              slope = norm[4 * n + 3];

  // --- stage the window with norm + act in fp32, zero outside the volume,
  //     rounded to bf16; all of a thread's loads are issued first
  float raw[PER];
  bool live[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int v = tid + i * kThreads;
    const int iz = v % kWZ, iy = v / kWZ % WY, ix = v / kWZ / WY;
    const int gx = x0 - 1 + ix, gy = y0 - 1 + iy, gz = z0 - 1 + iz;
    live[i] = v < WIN && gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z;
    raw[i] = live[i] ? __bfloat162float(x[((size_t)(xn + gx) * Y + gy) * Z + gz]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int v = tid + i * kThreads;
    if (v < WIN) {
      float a = (raw[i] - mean) * scale + beta;
      a = a >= 0.f ? a : a * slope;
      win[v] = __bfloat16_as_ushort(__float2bfloat16_rn(live[i] ? a : 0.f));
    }
  }

  // B: the tile's two k16 steps, all in registers; column pair p of the
  // whole cout at index (s * cout_p / 16 + p) * 32 + lane
  const int g = lane >> 2, t = lane & 3;
  uint4 b[2][NB];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int p = 0; p < NB; ++p) b[s][p] = __ldg(wpk + (s * (cout_p / 16) + nb * NB + p) * 32 + lane);
  // window offset of tap k = 16s + 8hk + 2t + e, the k of A register
  // (hr + 2hk) of k step s, element e; padded taps read tap 0
  int off[2][2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * s + 8 * hk + 2 * t + e;
        off[s][hk][e] = k < 27 ? ((k / 9) * WY + (k / 3) % 3) * kWZ + k % 3 : 0;
      }
  __syncthreads();

  float acc[MW][NT][4];
#pragma unroll
  for (int f = 0; f < MW; ++f) {
    const int r = warp * MW + f;
    const uint16_t* wf = win + ((r / TY) * WY + r % TY) * kWZ + g;  // row g at tap 0
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[4];
#pragma unroll
      for (int hk = 0; hk < 2; ++hk)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint16_t* p = wf + 8 * hr;
          a[hr + 2 * hk] = (uint32_t)p[off[s][hk][0]] | ((uint32_t)p[off[s][hk][1]] << 16);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t b0 = (j & 1) ? b[s][j / 2].z : b[s][j / 2].x;
        const uint32_t b1 = (j & 1) ? b[s][j / 2].w : b[s][j / 2].y;
        mma_bf16(acc[f][j], a, b0, b1);
      }
    }
  }
  fused_epilogue<32, OutT>(acc, bias, y, sums + (size_t)n * 2 * cout_p, red, X, Y, Z, xn, x0, y0,
                           z0, nb, cout_p, ldy);
}

// Finishing pass of a split call: y = sum of the splits' partial sums (in
// split order) + bias, rounded once, and the per-channel sums of those fp32
// values. A block owns kFinCols columns of kFinVox voxels of sample
// blockIdx.z; thread (r, q) holds 4 columns of voxel rows r, r + kFinRows,
// ... It reads each workspace value once and writes y once, so it is bound
// by the bytes.
constexpr int kFinCols = 32;
constexpr int kFinRows = kThreads / (kFinCols / 4);
constexpr int kFinVox = 4 * kFinRows;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ ws,    // (N, splits, nvox, cout_p)
                  const float* __restrict__ bias,  // (cout_p,)
                  OutT* __restrict__ y,            // (N, nvox) voxels, ldy apart
                  float* __restrict__ sums,        // (N, 2, cout_p)
                  int nvox, int cout_p, int ldy, int splits) {
  __shared__ float red[kWarps][2][kFinCols];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid % (kFinCols / 4), r = tid / (kFinCols / 4);
  const int col = blockIdx.y * kFinCols + 4 * q;
  const size_t slice = (size_t)nvox * cout_p;
  ws += blockIdx.z * splits * slice;
  y += blockIdx.z * (size_t)nvox * ldy;
  sums += (size_t)blockIdx.z * 2 * cout_p;
  const float4 bv = *reinterpret_cast<const float4*>(bias + col);
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  const int v_end = min(nvox, (int)(blockIdx.x + 1) * kFinVox);
  for (int v = blockIdx.x * kFinVox + r; v < v_end; v += kFinRows) {
    const float* src = ws + (size_t)v * cout_p + col;
    float4 a = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int k = 1; k < splits; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(src + k * slice);
      a.x += p.x;
      a.y += p.y;
      a.z += p.z;
      a.w += p.w;
    }
    const float o[4] = {a.x + bv.x, a.y + bv.y, a.z + bv.z, a.w + bv.w};
    OutT* dst = y + (size_t)v * ldy + col;
    store2(dst, o[0], o[1]);
    store2(dst + 2, o[2], o[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1[e] += o[e];
      s2[e] += o[e] * o[e];
    }
  }
  // lanes q, q + 8, q + 16, q + 24 of a warp hold the same columns
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int m = kFinCols / 4; m < 32; m <<= 1) {
      s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], m);
      s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], m);
    }
  if (lane < kFinCols / 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[warp][0][4 * q + e] = s1[e];
      red[warp][1][4 * q + e] = s2[e];
    }
  }
  __syncthreads();
  if (tid < 2 * kFinCols) {  // tid = which * kFinCols + column of the block
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][tid / kFinCols][tid % kFinCols];
    atomicAdd(&sums[(tid / kFinCols) * cout_p + blockIdx.y * kFinCols + tid % kFinCols], v);
  }
}

int blocks_x(int X, int Y, int Z, int ty) {
  return ((X + kTX - 1) / kTX) * ((Y + ty - 1) / ty) * ((Z + kTZ - 1) / kTZ);
}

template <int BN, int CK, typename OutT, bool SPLIT>
int launch(const void* x, const void* norm, const void* w, const void* bias, void* y, void* sums,
           void* ws, int N, int X, int Y, int Z, int cin, int nchunks, int cout_p, int ldy,
           int splits, int taps, cudaStream_t st) {
  using B = Brick<BN>;
  const size_t bytes = (size_t)4 * nchunks * CK * 4 + (size_t)kWarps * 2 * BN * 4 +
                       (size_t)kWX * B::WY * kWZ * (CK + 8) * 2;
  auto kern = conv_in_act_kernel<BN, CK, OutT, SPLIT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_x(X, Y, Z, B::TY), cout_p / BN, N * splits);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(norm),
      static_cast<const uint4*>(w), static_cast<const float*>(bias), static_cast<OutT*>(y),
      static_cast<float*>(sums), static_cast<float*>(ws), X, Y, Z, cin, nchunks, cout_p, ldy,
      splits, taps);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_conv1(const void* x, const void* norm, const void* w, const void* bias, void* y,
                 void* sums, int N, int X, int Y, int Z, int cout_p, int ldy, cudaStream_t st) {
  dim3 grid(blocks_x(X, Y, Z, Brick<32>::TY), cout_p / 32, N);
  conv1_kernel<OutT><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(norm),
      static_cast<const uint4*>(w), static_cast<const float*>(bias), static_cast<OutT*>(y),
      static_cast<float*>(sums), X, Y, Z, cout_p, ldy);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch(const void* x, const void* norm, const void* w, const void* bias, void* y,
             void* sums, void* ws, int N, int X, int Y, int Z, int cin, int ck, int nchunks,
             int cout_p, int bn, int ldy, int splits, int taps, cudaStream_t st) {
  if (ck == 1) return launch_conv1<OutT>(x, norm, w, bias, y, sums, N, X, Y, Z, cout_p, ldy, st);
#define BOA_LAUNCH(BN, CK)                                                                    \
  if (bn == BN && ck == CK)                                                                   \
    return splits > 1 ? launch<BN, CK, OutT, true>(x, norm, w, bias, y, sums, ws, N, X, Y, Z,  \
                                                   cin, nchunks, cout_p, ldy, splits, taps,    \
                                                   st)                                         \
                      : launch<BN, CK, OutT, false>(x, norm, w, bias, y, sums, ws, N, X, Y, Z, \
                                                    cin, nchunks, cout_p, ldy, 1, 1, st);
  BOA_LAUNCH(64, 32)
  BOA_LAUNCH(64, 16)
  BOA_LAUNCH(32, 32)
  BOA_LAUNCH(32, 16)
#undef BOA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the cudaError_t of
// its launch (0 on success).
//
// boa_conv_in_act_fwd: the conv.
//   x     (N, X, Y, Z, cin) bf16, contiguous, 16-byte aligned, any cin >= 1
//   norm  (N, 4, nchunks * ck) float32 rows [mean, inv_std * gamma, beta,
//         slope] per sample; channels past cin need scale 0
//   w     B fragments: for N tile nb < cout_p / bn, chunk c < nchunks,
//         tap = (dx*3 + dy)*3 + dz, k step s < ck/16, column pair p < bn/16
//         and lane = 4g + t, the 16 bytes at index
//         ((((nb*nchunks + c)*27 + tap)*(ck/16) + s)*(bn/16) + p)*32 + lane
//         hold the bf16 values w[tap, c*ck + s*16 + 8h + 2t + e,
//         nb*bn + p*16 + 8q + g] in (q, h, e) order, zero past cin / cout.
//         ck = 1 (cin = 1, taps folded into K): for k step s < 2, column
//         pair p < cout_p/16 and lane, the 16 bytes at index
//         (s*(cout_p/16) + p)*32 + lane hold w[k = s*16 + 8h + 2t + e,
//         p*16 + 8q + g] in (q, h, e) order, k the tap, zero for k >= 27
//   bias  (cout_p,) float32;  sums (N, 2, cout_p) float32, zeroed by the caller
//   y     output voxel (n, x, y, z) at element ((n*X + x)*Y + y)*Z + z times
//         ldy, its cout_p channels contiguous (ldy >= cout_p, even); bf16 or
//         float32 (out_f32)
//   ck    16 or 32 channels per chunk, or 1 for the tap-folded input conv
//         (cin = 1, nchunks = 1, bn = 32, splits = 1);  bn 32 or 64 columns
//         per N tile, cout_p a multiple of bn
//   splits, taps: K is nchunks * taps units (taps 1: a unit is a chunk;
//         taps 3: a chunk's dx tap plane), split into `splits` contiguous
//         ranges, 1 <= splits <= nchunks * taps, N * splits <= 65535.
//         splits = 1: y, sums are written and ws is not read. splits > 1:
//         y, bias and sums are not touched; split k of sample n writes its
//         raw sums to ws (N, splits, X*Y*Z, cout_p) float32 slice (n, k),
//         and boa_conv_in_act_finish completes
extern "C" int boa_conv_in_act_fwd(const void* x, const void* norm, const void* w,
                                   const void* bias, void* y, void* sums, void* ws, int N, int X,
                                   int Y, int Z, int cin, int ck, int nchunks, int cout_p, int bn,
                                   int ldy, int splits, int taps, int out_f32, void* stream) {
  const bool fold = ck == 1;
  if (cin < 1 || nchunks * ck < cin || (nchunks - 1) * ck >= cin || bn <= 0 || cout_p % bn != 0 ||
      N < 1 || X < 1 || Y < 1 || Z < 1 || ldy < cout_p || ldy % 2 != 0 ||
      (taps != 1 && taps != 3) || splits < 1 || splits > nchunks * taps ||
      (long long)N * splits > 65535 || (splits > 1 && ws == nullptr) ||
      (fold && (bn != 32 || splits != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<float>(x, norm, w, bias, y, sums, ws, N, X, Y, Z, cin, ck, nchunks,
                                   cout_p, bn, ldy, splits, taps, st)
                 : dispatch<__nv_bfloat16>(x, norm, w, bias, y, sums, ws, N, X, Y, Z, cin, ck,
                                           nchunks, cout_p, bn, ldy, splits, taps, st);
}

// boa_conv_in_act_finish: completes a call made with splits > 1.
//   ws (N, splits, nvox, cout_p) float32 from boa_conv_in_act_fwd; bias
//   (cout_p,) float32; y voxel v of sample n at element (n*nvox + v)*ldy,
//   bf16 or float32 (out_f32), ldy >= cout_p and even; sums (N, 2, cout_p)
//   float32, zeroed by the caller; cout_p a multiple of 32
extern "C" int boa_conv_in_act_finish(const void* ws, const void* bias, void* y, void* sums,
                                      int N, int nvox, int cout_p, int ldy, int splits,
                                      int out_f32, void* stream) {
  if (N < 1 || N > 65535 || nvox < 1 || cout_p < kFinCols || cout_p % kFinCols != 0 ||
      ldy < cout_p || ldy % 2 != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((nvox + kFinVox - 1) / kFinVox, cout_p / kFinCols, N);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  if (out_f32)
    finish_kernel<float><<<grid, kThreads, 0, st>>>(w, b, static_cast<float*>(y),
                                                    static_cast<float*>(sums), nvox, cout_p, ldy,
                                                    splits);
  else
    finish_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(w, b,
                                                            static_cast<__nv_bfloat16*>(y),
                                                            static_cast<float*>(sums), nvox,
                                                            cout_p, ldy, splits);
  return (int)cudaGetLastError();
}
