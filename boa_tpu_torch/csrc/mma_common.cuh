// Device helpers shared by the kernels of csrc/: the input-side norm +
// activation of 8 channels, the ldmatrix / mma.sync wrappers, the paired
// output stores and the cp.async (16-byte, L2 only) copies.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace boa {

// norm rows [mean, scale, beta, slope] of 8 consecutive channels c0..c0+7
struct Norm8 {
  float4 m[2], s[2], b[2], l[2];
};

// `normp` holds the rows [mean, scale, beta, slope], each `cin_k` floats long
__device__ __forceinline__ Norm8 load_norm8(const float* normp, int cin_k, int c0) {
  const float4* p = reinterpret_cast<const float4*>(normp + c0);
  const int row = cin_k / 4;  // float4 per norm row
  return Norm8{{p[0], p[1]}, {p[row], p[row + 1]}, {p[2 * row], p[2 * row + 1]},
               {p[3 * row], p[3 * row + 1]}};
}

// act of 8 consecutive channels held as bf16 in `raw`, rounded to bf16:
// LeakyReLU_slope((x - mean) * scale + beta), all in fp32
__device__ __forceinline__ uint4 act8(uint4 raw, const Norm8& n) {
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4& mm = n.m[i / 2];
    const float4& ss = n.s[i / 2];
    const float4& bb = n.b[i / 2];
    const float4& ll = n.l[i / 2];
    const bool zw = i & 1;  // channels in the .z/.w half of the float4s
    float v0 = __uint_as_float(in[i] << 16), v1 = __uint_as_float(in[i] & 0xffff0000u);
    v0 = (v0 - (zw ? mm.z : mm.x)) * (zw ? ss.z : ss.x) + (zw ? bb.z : bb.x);
    v1 = (v1 - (zw ? mm.w : mm.y)) * (zw ? ss.w : ss.y) + (zw ? bb.w : bb.y);
    v0 = v0 >= 0.f ? v0 : v0 * (zw ? ll.z : ll.x);
    v1 = v1 >= 0.f ? v1 : v1 * (zw ? ll.w : ll.y);
    __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
    out[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint4 act8(uint4 raw, const float* normp, int cin_k, int c0) {
  return act8(raw, load_norm8(normp, cin_k, c0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace boa
