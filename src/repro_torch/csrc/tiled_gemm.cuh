// Shared-memory tiled matrix product for the port's hand-written kernels.
//
// C[z] (M x N, row stride ldc) = A[z] (M x K, row stride lda)
//                                @ B[z] (K x N, row stride ldb)
// for z = blockIdx.z, with batch strides sa/sb/sc in elements.  Inputs are
// float or __nv_bfloat16; products accumulate in fp32 registers and round
// once to the output type, as the TPU kernels' fp32 VMEM accumulators do.
//
// One block computes a BM x BN tile of C.  It walks K in BK-deep steps:
// the block stages an A tile (transposed, one padding column against bank
// conflicts) and a B tile in shared memory, then each thread accumulates a
// TM x TN micro-tile from them.  A thread's TN columns are TX apart, so a
// warp reads neighbouring shared-memory words and writes neighbouring
// global addresses.  Ragged M/N/K edges are masked on load and store; no
// operand is padded or copied.  Blocks are independent (no cross-block
// reduction), which takes the place of the TPU grid's sequential K axis.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tiled_gemm(const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ c, int M, int N, int K, int lda, int ldb, int ldc,
           long long sa, long long sb, long long sc) {
  constexpr int TX = BN / TN;  // threads along N
  constexpr int TY = BM / TM;  // threads along M
  constexpr int NT = TX * TY;
  __shared__ float as[BK][BM + 1];  // A tile, transposed: as[k][m]
  __shared__ float bs[BK][BN];      // B tile

  a += blockIdx.z * sa;
  b += blockIdx.z * sb;
  c += blockIdx.z * sc;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // neighbouring threads load neighbouring k (A) and n (B): coalesced
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < M && gk < K)
                      ? to_f32(a[(long long)gm * lda + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += NT) {
      const int kk = e / BN, col = e % BN;
      const int gk = k0 + kk, gn = n0 + col;
      bs[kk][col] = (gk < K && gn < N)
                        ? to_f32(b[(long long)gk * ldb + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) c[(long long)gm * ldc + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

// Launch one tile configuration over a (batch x M x N) problem on `stream`;
// returns cudaGetLastError() so the caller sees a refused launch.
template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_tiled_gemm(const void* a, const void* b, void* c, int batch, int M,
                      int N, int K, int lda, int ldb, int ldc, long long sa,
                      long long sb, long long sc, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const dim3 block((BM / TM) * (BN / TN));
  tiled_gemm<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, lda, ldb, ldc, sa, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
