// 2x2x2 stride-2 transposed conv (the decoder's last upsample) for Hopper
// (sm_90a), bf16 in, fp32 accumulate, channels-last.
//
// Replaces: boa_tpu/ops/rowconv.py `_transp_kernel`. Contract:
//   out[n, 2x+a, 2y+b, 2z+c, co] = sum_ci x[n, x, y, z, ci] * w[a, b, c, ci, co]
// Every output voxel receives exactly one tap, so the op is one GEMM
// [voxels x cin] . [cin x 8*cout] whose epilogue scatters each column group
// (a, b, c) to its parity position. The caller adds the bias.
//
// What bounds it on an H100: at the main path's shape (64^3 x 64 -> 128^3 x
// 32) it moves 34 MB in and 134 MB out for 8.6 GFLOP, ~51 FLOP/byte: memory
// bound (0.05 ms at 3.35 TB/s against 0.009 ms of tensor-core time).
//
// Design (first, simple version): a block takes 64 input voxels (one
// contiguous row block of the channels-last input) and one (a, b) parity
// pair, i.e. a 64 x (2*cout) output tile whose rows land as contiguous runs
// of 2*cout values (c, co) at consecutive output z. The A tile is staged in
// shared memory with 16-byte loads (zero-filled past the end), WMMA
// (mma.sync) computes the tile, and the epilogue goes through shared memory
// so the stores are coalesced. Not yet done (later work): writing the
// result straight into the channel slice of the decoder concat, and the
// bias add in the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;  // input voxels per block (4 warps x 16)
constexpr int kThreads = 128;

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <int COUT, typename OutT>
__global__ void transp_kernel(const __nv_bfloat16* __restrict__ x,  // (M, cin), M = N*X*Y*Z
                              const __nv_bfloat16* __restrict__ w,  // (4, cin, 2*COUT)
                              OutT* __restrict__ y,                 // (N, 2X, 2Y, 2Z, COUT)
                              long long M, int X, int Y, int Z, int cin) {
  constexpr int NCOL = 2 * COUT;  // (c, co) columns of one (a, b) pair
  constexpr int NF = NCOL / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(smem);            // (kRows, cin)
  float* epi = reinterpret_cast<float*>(smem + (size_t)kRows * cin * 2);  // (kRows, NCOL)

  const int tid = threadIdx.x;
  const int ab = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * kRows;

  const int c8n = cin / 8;
  for (int u = tid; u < kRows * c8n; u += kThreads) {
    const long long m = m0 + u / c8n;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M) v = *reinterpret_cast<const uint4*>(x + m * cin + (u % c8n) * 8);
    *reinterpret_cast<uint4*>(at + (size_t)u * 8) = v;
  }
  __syncthreads();

  const int warp = tid / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
  const __nv_bfloat16* wab = w + (size_t)ab * cin * NCOL;
  for (int ks = 0; ks < cin / 16; ++ks) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, at + (size_t)warp * 16 * cin + ks * 16, cin);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(b, wab + (size_t)ks * 16 * NCOL + f * 16, NCOL);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(epi + warp * 16 * NCOL + f * 16, acc[f], NCOL, wmma::mem_row_major);
  __syncthreads();

  const int pa = ab / 2, pb = ab % 2;
  for (int idx = tid; idx < kRows * NCOL; idx += kThreads) {
    const long long m = m0 + idx / NCOL;
    if (m >= M) continue;
    const int col = idx % NCOL;
    const int pc = col / COUT, co = col % COUT;
    const int z = (int)(m % Z);
    long long t = m / Z;
    const int yy = (int)(t % Y);
    t /= Y;
    const int xx = (int)(t % X);
    const long long n = t / X;
    const size_t dst =
        ((((size_t)n * 2 * X + 2 * xx + pa) * 2 * Y + 2 * yy + pb) * 2 * Z + 2 * z + pc) * COUT + co;
    store_out(y + dst, epi[idx]);
  }
}

template <int COUT, typename OutT>
int launch_transp(const void* x, const void* w, void* y, int N, int X, int Y, int Z, int cin,
                  cudaStream_t st) {
  const long long M = (long long)N * X * Y * Z;
  const size_t bytes = (size_t)kRows * cin * 2 + (size_t)kRows * 2 * COUT * 4;
  auto kern = transp_kernel<COUT, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + kRows - 1) / kRows), 4);
  kern<<<grid, kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(x),
                                      static_cast<const __nv_bfloat16*>(w),
                                      static_cast<OutT*>(y), M, X, Y, Z, cin);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch_cout(const void* x, const void* w, void* y, int N, int X, int Y, int Z, int cin,
                  int cout, cudaStream_t st) {
  switch (cout) {
    case 8: return launch_transp<8, OutT>(x, w, y, N, X, Y, Z, cin, st);
    case 16: return launch_transp<16, OutT>(x, w, y, N, X, Y, Z, cin, st);
    case 32: return launch_transp<32, OutT>(x, w, y, N, X, Y, Z, cin, st);
    case 64: return launch_transp<64, OutT>(x, w, y, N, X, Y, Z, cin, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). cin must be a multiple of 16,
// cout one of 8/16/32/64. Returns the cudaError_t of the launch.
extern "C" int boa_transpconv2_fwd(const void* x, const void* w, void* y, int N, int X, int Y,
                                   int Z, int cin, int cout, int out_f32, void* stream) {
  if (cin % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch_cout<float>(x, w, y, N, X, Y, Z, cin, cout, st)
                 : dispatch_cout<__nv_bfloat16>(x, w, y, N, X, Y, Z, cin, cout, st);
}
