// ssd_chunk_scan: the chunked Mamba2 SSD scan.  For every (batch, head) the
// (hd, N) state h is carried through T tokens,
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,
// and the kernel returns the final state and y.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk/ssd_chunk.py:
// ssd_chunk_scan (body _ssd_chunk_kernel): a (B, H, T/L) grid with the chunk
// axis innermost and sequential, the state carried across chunk steps in
// VMEM scratch, L = 256 by default.
//
// What bounds it on an H100: at decode (T = 1, zamba2-7b: H = 112,
// hd = N = 64) it reads state0 and writes the final state once, 1.8 MB each
// in fp32, for ~0.3 Mflop: bound by bytes, about 1.1 us at 3.35 TB/s.  In
// chunked prefill (T in the thousands) it does ~(L + 2N) hd flops per token
// and head in shared memory and is bound by fp32 operations.
//
// What the design does about it: one block per (batch, head) runs the chunk
// loop in order, so the state never leaves shared memory between chunks
// (this loop takes the place of the TPU's sequential grid axis).  Per chunk
// of L <= 64 tokens (the TPU's L = 256 would need a 256 KB (L, L) tile, over
// the 227 KB a block can have) it stages x * dt, B and C in shared memory,
// takes the cumulative sum l of dt * a, and computes, as the TPU kernel does,
//   y_t = exp(l_t) C_t . h0 + sum_{j <= t} exp(l_t - l_j) (C_t . B_j) dt_j x_j
//   h'  = exp(l_L) h0 + sum_j exp(l_L - l_j) dt_j x_j B_j^T.
// Rows of the state, B and C are padded by one word, so threads walking hd
// or the chunk read distinct shared-memory banks.  Global loads and stores
// run along hd or N, coalesced.  Inputs are f32 or bf16; all arithmetic is
// fp32.  Tensor-core products for long prefill chunks are later work.
#include "tiled_gemm.cuh"

#include <math.h>

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;

// Grid (H, B).  x, y (B, T, H, hd); b, c (B, T, N); dt (B, T, H); a (H);
// state0, sf (B, H, hd, N); L is the chunk length.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ b,
                 const T* __restrict__ c, const T* __restrict__ dt,
                 const T* __restrict__ a, const T* __restrict__ state0,
                 T* __restrict__ y, T* __restrict__ sf, int Tn, int H, int hd,
                 int N, int L) {
  extern __shared__ float smem[];
  const int NP = N + 1;      // padded row stride
  float* hs = smem;          // (hd, NP) running state
  float* xs = hs + hd * NP;  // (L, hd) dt_j x_j
  float* bs = xs + L * hd;   // (L, NP)
  float* cs = bs + L * NP;   // (L, NP)
  float* ws = cs + L * NP;   // (L, L) exp(l_t - l_j) C_t . B_j, j <= t
  float* ls = ws + L * L;    // (L) cumulative dt * a
  float* dts = ls + L;       // (L) dt
  float* els = dts + L;      // (L) exp(l_t)
  float* des = els + L;      // (L) exp(l_last - l_j)
  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x;
  const float ah = to_f32(a[h]);
  const long long sbase = ((long long)bi * H + h) * hd * N;

#pragma unroll 4
  for (int e = tid; e < hd * N; e += kThreads)
    hs[(e / N) * NP + e % N] = to_f32(state0[sbase + e]);

  for (int t0 = 0; t0 < Tn; t0 += L) {
    const int n = min(L, Tn - t0);
    const long long row0 = (long long)bi * Tn + t0;  // first token's row
    for (int j = tid; j < n; j += kThreads)
      dts[j] = to_f32(dt[(row0 + j) * H + h]);
    for (int e = tid; e < n * N; e += kThreads) {
      const int j = e / N, k = e % N;
      bs[j * NP + k] = to_f32(b[(row0 + j) * N + k]);
      cs[j * NP + k] = to_f32(c[(row0 + j) * N + k]);
    }
    __syncthreads();
    for (int e = tid; e < n * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      xs[j * hd + d] = to_f32(x[((row0 + j) * H + h) * hd + d]) * dts[j];
    }
    if (tid == 0) {  // the chunk's cumulative log-decay, in token order
      float run = 0.f;
      for (int j = 0; j < n; ++j) {
        run = fmaf(dts[j], ah, run);
        ls[j] = run;
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      els[j] = expf(ls[j]);
      des[j] = expf(ls[n - 1] - ls[j]);
    }
    for (int e = tid; e < n * n; e += kThreads) {
      const int t = e / n, j = e % n;
      float w = 0.f;
      if (j <= t) {
        float s = 0.f;
        for (int k = 0; k < N; ++k) s = fmaf(cs[t * NP + k], bs[j * NP + k], s);
        w = expf(ls[t] - ls[j]) * s;
      }
      ws[t * L + j] = w;
    }
    __syncthreads();
    // outputs: inter-chunk term from the carried state, intra-chunk term
    for (int e = tid; e < n * hd; e += kThreads) {
      const int t = e / hd, d = e % hd;
      float inter = 0.f;
      for (int k = 0; k < N; ++k) inter = fmaf(cs[t * NP + k], hs[d * NP + k], inter);
      float intra = 0.f;
      for (int j = 0; j <= t; ++j) intra = fmaf(ws[t * L + j], xs[j * hd + d], intra);
      y[((row0 + t) * H + h) * hd + d] = from_f32<T>(fmaf(els[t], inter, intra));
    }
    __syncthreads();
    // the state at the chunk's end; each thread owns its (d, k) entries
    const float decay = els[n - 1];
    for (int e = tid; e < hd * N; e += kThreads) {
      const int d = e / N, k = e % N;
      float acc = decay * hs[d * NP + k];
      for (int j = 0; j < n; ++j)
        acc = fmaf(des[j] * xs[j * hd + d], bs[j * NP + k], acc);
      hs[d * NP + k] = acc;
    }
    __syncthreads();
  }

#pragma unroll 4
  for (int e = tid; e < hd * N; e += kThreads)
    sf[sbase + e] = from_f32<T>(hs[(e / N) * NP + e % N]);
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* dt,
           const void* a, const void* state0, void* y, void* sf, int B, int Tn,
           int H, int hd, int N, int L, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_chunk_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(dt),
      static_cast<const T*>(a), static_cast<const T*>(state0),
      static_cast<T*>(y), static_cast<T*>(sf), Tn, H, hd, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// device: the CUDA device of the operands and the stream.  dtype: 0 =
// float32, 1 = bfloat16, for every operand.  All operands are contiguous:
// x and y (B, T, H, hd), b and c (B, T, N), dt (B, T, H), a (H), state0 and
// sf (B, H, hd, N).  L is the chunk length and smem the shared memory it
// needs, 4 * (hd (N+1) + L hd + 2 L (N+1) + L^2 + 4 L) bytes, which the
// caller has checked fits a block.  Returns the CUDA error code of the launch.
extern "C" int ssd_chunk_launch(int device, int dtype, const void* x,
                                const void* b, const void* c, const void* dt,
                                const void* a, const void* state0, void* y,
                                void* sf, int B, int Tn, int H, int hd, int N,
                                int L, int smem, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, b, c, dt, a, state0, y, sf, B, Tn, H, hd, N, L,
                         smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, b, c, dt, a, state0, y, sf, B, Tn, H, hd,
                                 N, L, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
