// hadamard_matmul: M[g] = U[g] @ V[g] for the 16 points g of the Winograd
// F(2x2, 3x3) Hadamard domain.
//
// Replaces the TPU kernel src/repro/kernels/winograd_conv/winograd_conv.py:
// hadamard_matmul (body _hadamard_matmul_kernel), which runs the 16 products
// on a (16, P/bm, N/bn, K/bk) grid with (128, 128, 256) VMEM blocks and an
// fp32 accumulator.
//
// What bounds it on an H100: U is (16, P, K), V is (16, K, N) and M is
// (16, P, N), with P = B * ceil(H/2) * ceil(W/2) tiles.  At VGG16's
// Winograd layers K and N are 64..256, so each U and M element is touched
// K or N times: the work is bound by fp32 operations (2 * 16 * P * K * N at
// 67 TFLOP/s outside the tensor cores; fp32 stays true fp32, no TF32), or
// at the smallest K about as much by the bytes of U and M.
//
// What the design does about it (`hadamard_gemm`):
// - The Winograd point is blockIdx.z, so the 16 products are one launch of
//   independent blocks.  A block computes a BM x BN tile of M[g] (128 x 128,
//   128 x 64 or 64 x 128, chosen per shape on the host so that the busiest
//   SM has the fewest rounds of blocks: repro_torch/kernels/winograd_conv/
//   winograd_conv.py: plan_hadamard) with (BM / 8) x (BN / 8) threads,
//   each holding an 8 x 8 register micro-tile.
// - K is walked in 16-deep slices through a ring of kStages shared-memory
//   stages filled by cp.async 16-byte copies: while one slice is computed,
//   the next kStages - 1 are in flight.  Ragged P, K and N edges are
//   zero-filled by the copy itself (src-size 0), so the inner loop has no
//   masks.  cp.async cannot transpose, so A keeps its row-major layout in
//   shared memory and is read 2 k-values at a time: per 2 k-steps a thread
//   does 8 8-byte loads of A and 4 16-byte loads of B for 128 fused
//   multiply-adds.  Launch bounds fix how many blocks an SM holds (two
//   128 x 128, three 128 x 64 or 64 x 128); the plan counts rounds with
//   those numbers.
// - The 16-byte copies need U, V, K * sizeof(T) and N * sizeof(T) 16-byte
//   aligned; otherwise the same kernel stages its slices with scalar loads
//   (bf16 elements are 2 bytes, below cp.async's 4-byte minimum).
// - bf16 operands are staged as bf16 and widened to fp32 in registers, so
//   both types accumulate in fp32 and round once to T.
#include <cstdint>

#include "kernel_attrs.cuh"
#include "tiled_gemm.cuh"

namespace {

using repro_torch::configure_smem_once;
using repro_torch::from_f32;

constexpr int kBK = 16;      // depth of one K slice
constexpr int kStages = 3;   // K slices in the shared-memory ring
constexpr int kTM = 8, kTN = 8;

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

// four consecutive elements of a shared-memory row as floats
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);      // bf16 is the high half of fp32
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// two consecutive elements of a shared-memory row as floats
__device__ __forceinline__ void load2(const float* p, float* f) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x;
  f[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* f) {
  const unsigned int v = *reinterpret_cast<const unsigned int*>(p);
  f[0] = __uint_as_float(v << 16);
  f[1] = __uint_as_float(v & 0xffff0000u);
}

// four consecutive outputs, one store
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(f[0], f[1]);
  q[1] = __floats2bfloat162_rn(f[2], f[3]);
}

// Stage K slice `kt` of A (BM x kBK, row-major) and B (kBK x BN) into one
// ring slot.  VEC: 16-byte cp.async copies, zero-filled outside P, K, N.
template <typename T, int BM, int BN, bool VEC>
__device__ __forceinline__ void stage(T* as, T* bs, const T* __restrict__ a,
                                      const T* __restrict__ b, int m0,
                                      int n0, int kt, int P, int K, int N) {
  constexpr int NT = (BM / kTM) * (BN / kTN);
  const int k0 = kt * kBK;
  if constexpr (VEC) {
    constexpr int CE = 16 / static_cast<int>(sizeof(T));  // elements/copy
#pragma unroll
    for (int c = threadIdx.x; c < BM * kBK / CE; c += NT) {
      const int row = c / (kBK / CE), kc = (c % (kBK / CE)) * CE;
      const int gm = m0 + row, gk = k0 + kc;
      const bool ok = gm < P && gk < K;
      cp_async16(as + row * kBK + kc, ok ? a + (long long)gm * K + gk : a,
                 ok);
    }
#pragma unroll
    for (int c = threadIdx.x; c < kBK * BN / CE; c += NT) {
      const int row = c / (BN / CE), nc = (c % (BN / CE)) * CE;
      const int gk = k0 + row, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(bs + row * BN + nc, ok ? b + (long long)gk * N + gn : b,
                 ok);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int e = threadIdx.x; e < BM * kBK; e += NT) {
      const int row = e / kBK, kk = e % kBK;
      const int gm = m0 + row, gk = k0 + kk;
      as[e] = (gm < P && gk < K) ? a[(long long)gm * K + gk] : zero;
    }
    for (int e = threadIdx.x; e < kBK * BN; e += NT) {
      const int row = e / BN, col = e % BN;
      const int gk = k0 + row, gn = n0 + col;
      bs[e] = (gk < K && gn < N) ? b[(long long)gk * N + gn] : zero;
    }
  }
}

// Blocks of a tile an SM must hold at once: two 128 x 128 (512 threads, at
// most 128 registers each), or three of the 128-thread tiles (at most 168
// registers: at 128 they spill).
template <int BM, int BN>
constexpr int min_blocks() { return BM * BN == 128 * 128 ? 2 : 3; }

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN),
                                  min_blocks<BM, BN>())
hadamard_gemm(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int P, int K, int N) {
  constexpr int TX = BN / kTN;         // threads along N
  constexpr int TY = BM / kTM;         // threads along M
  constexpr int A_ELEMS = BM * kBK, B_ELEMS = kBK * BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);   // kStages x (A, B)

  const long long g = blockIdx.z;
  a += g * P * K;
  b += g * K * N;
  c += g * P * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int nk = (K + kBK - 1) / kBK;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // prologue: slices 0 .. kStages - 2 in flight, one commit group each
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      T* slot = ring + s * (A_ELEMS + B_ELEMS);
      stage<T, BM, BN, VEC>(slot, slot + A_ELEMS, a, b, m0, n0, s, P, K, N);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    // slice kt has landed (at most kStages - 2 younger groups pending), and
    // every thread is past slice kt - 1, whose slot is refilled next
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) {
      T* slot = ring + (next % kStages) * (A_ELEMS + B_ELEMS);
      stage<T, BM, BN, VEC>(slot, slot + A_ELEMS, a, b, m0, n0, next, P, K,
                            N);
    }
    cp_async_commit();

    const T* as = ring + (kt % kStages) * (A_ELEMS + B_ELEMS);
    const T* bs = as + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 2) {
      float af[kTM][2];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        load2(as + (ty + i * TY) * kBK + kk, af[i]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float bf[kTN];
        load4(bs + (kk + q) * BN + tx * 4, bf);
        load4(bs + (kk + q) * BN + BN / 2 + tx * 4, bf + 4);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(af[i][q], bf[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  // a thread's rows are TY apart and its columns two runs of 4, BN / 2
  // apart: neighbouring threads read neighbouring shared-memory rows (no
  // bank conflict where a half-warp spans two rows) and store contiguously
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= P) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * (BN / 2) + tx * 4;
      const float f[4] = {acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]};
      T* out = c + (long long)gm * N + gn;
      if (VEC && gn + 4 <= N) {
        store4(out, f);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) out[j] = from_f32<T>(f[j]);
      }
    }
  }
}

template <typename T, int BM, int BN, bool VEC>
int launch_tile(int device, const void* u, const void* v, void* out, int g,
                int p, int k, int n, cudaStream_t stream) {
  constexpr int threads = (BM / kTM) * (BN / kTN);
  constexpr int smem = kStages * (BM * kBK + kBK * BN) * sizeof(T);
  // set once per device (kernel_attrs.cuh): no runtime call per launch,
  // so none inside a CUDA graph capture either
  const int set = configure_smem_once<hadamard_gemm<T, BM, BN, VEC>>(device);
  if (set != 0) return set;
  const dim3 grid((n + BN - 1) / BN, (p + BM - 1) / BM, g);
  hadamard_gemm<T, BM, BN, VEC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), static_cast<T*>(out),
      p, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int BN>
int launch_vec(int device, const void* u, const void* v, void* out, int g,
               int p, int k, int n, int vec, cudaStream_t stream) {
  return vec ? launch_tile<T, BM, BN, true>(device, u, v, out, g, p, k, n,
                                            stream)
             : launch_tile<T, BM, BN, false>(device, u, v, out, g, p, k, n,
                                             stream);
}

template <typename T>
int launch(int device, const void* u, const void* v, void* out, int g,
           int p, int k, int n, int bm, int bn, int vec,
           cudaStream_t stream) {
  // the host plan, checked: 16-byte copies only where they are aligned
  const bool aligned =
      reinterpret_cast<std::uintptr_t>(u) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(v) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
      (static_cast<long long>(k) * sizeof(T)) % 16 == 0 &&
      (static_cast<long long>(n) * sizeof(T)) % 16 == 0;
  if (vec && !aligned) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128 && bn == 128)
    return launch_vec<T, 128, 128>(device, u, v, out, g, p, k, n, vec,
                                   stream);
  if (bm == 128 && bn == 64)
    return launch_vec<T, 128, 64>(device, u, v, out, g, p, k, n, vec,
                                   stream);
  if (bm == 64 && bn == 128)
    return launch_vec<T, 64, 128>(device, u, v, out, g, p, k, n, vec,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// device: the CUDA device the operands and the stream belong to.
// dtype: 0 = float32, 1 = bfloat16.  u (g, p, k), v (g, k, n) and
// out (g, p, n) are contiguous.  The tile bm x bn (128 x 128, 128 x 64 or
// 64 x 128) and vec
// (1: 16-byte cp.async copies, 0: scalar staging) come from the host
// planner.  Returns
// the CUDA error code of the launch.
extern "C" int hadamard_matmul_launch(int device, int dtype, const void* u,
                                      const void* v, void* out, int g, int p,
                                      int k, int n, int bm, int bn, int vec,
                                      void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(device, u, v, out, g, p, k, n, bm, bn, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, u, v, out, g, p, k, n, bm, bn, vec,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
