// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// that multiply on the tensor cores in fp32 accuracy (ssd_chunk.cu,
// split_matmul.cu): the cp.async wrappers, the 3xTF32 split of an fp32
// operand into its TF32 parts, mma.sync m16n8k8 in TF32, and the paired
// loads and stores their fragments use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tiled_gemm.cuh"

namespace repro_torch {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;       // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---- tensor-core products, 3xTF32

// v's TF32 part: its fp32 bits with the 13 low mantissa bits cleared
// (truncation: one logic op, where rounding takes several)
__device__ __forceinline__ uint32_t tf32(float v) {
  return __float_as_uint(v) & 0xffffe000u;
}

// An m16n8k8 operand fragment as its two TF32 parts, v = big + small:
// big = tf32(v), small = tf32(v - big) (v - big is exact in fp32), so
// |v - big - small| < 2^-20 |v|
template <int R>
struct Frag {
  uint32_t big[R], small[R];
  __device__ __forceinline__ void set(int i, float v) {
    big[i] = tf32(v);
    small[i] = tf32(v - __uint_as_float(big[i]));
  }
};
// With the lane's groupID g and threadID_in_group t, the fragments hold
// a0..a3 at (row, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b0,
// b1 at (k, n) = (t, g), (t + 4, g); the accumulator's c0..c3 at (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  The kernels give the k slots
// t and t + 4 of a step of 8 the neighbouring columns k0 + 2t and k0 + 2t
// + 1 of A and B (any order of k in a step sums the same terms), so a lane
// reads both with one load where they are neighbours in shared memory.
using FragA = Frag<4>;
using FragB = Frag<2>;

// two neighbouring elements of a shared-memory row (even index) as floats
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16),     // bf16: fp32's high half
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[i] += a b[i] for the first `live` of a warp's four column tiles at fp32
// accuracy: small big, big small, then big big, in passes over the tiles,
// so that neighbouring MMAs write different accumulators and issue without
// waiting on each other
__device__ __forceinline__ void mma3(float (&d)[4][4], const FragA& a,
                                     const FragB (&b)[4], int live = 4) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < live) mma_tf32(d[i], a.small, b[i].big[0], b[i].big[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < live) mma_tf32(d[i], a.big, b[i].small[0], b[i].small[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < live) mma_tf32(d[i], a.big, b[i].big[0], b[i].big[1]);
}

// two neighbouring outputs of a row, one store where the pair is aligned
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// row[k], row[k + 1] of a row of `width` valid elements (k even; the row's
// address is even where the width is)
template <typename U>
__device__ __forceinline__ void store_pair(U* row, int k, int width, float v0,
                                           float v1) {
  if (width % 2 == 0 && k + 1 < width) {
    store2(row + k, v0, v1);
  } else {
    if (k < width) row[k] = from_f32<U>(v0);
    if (k + 1 < width) row[k + 1] = from_f32<U>(v1);
  }
}

}  // namespace repro_torch
