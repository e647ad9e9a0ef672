// decode_attention: one query token attends to an S-position KV cache (GQA),
// returning the normalized output and each query head's log-sum-exp.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/decode_attention.py:
// decode_attention (body _decode_attn_kernel): a (KV heads, S/bs) grid with
// S innermost and sequential, the online-softmax (max, sum, acc) state carried
// from one grid step to the next in VMEM scratch, and the g = H/KV query
// heads of one KV head padded to 8 rows as the MXU operand.
//
// What bounds it on an H100: every K and V element is read once and feeds 2g
// flops, so at decode the kernel is bound by bytes.  The zamba2-7b attention
// node reads 2 x 4096 x 32 x 112 x 4 B = 117 MB of fp32 cache: 35 us at
// 3.35 TB/s.
//
// What the design does about it: Hopper blocks run in no order, so the TPU's
// sequential S axis becomes independent blocks plus a second pass.  Pass 1
// runs one block per (KV head, block of bs positions).  It scores its
// positions for the g query heads of its KV head with a warp per position and
// the lanes along hd, so each K row is read in coalesced runs; takes the
// block's softmax max and sum in shared memory; and accumulates P @ V with
// threads along (head, hd), so V rows are read coalesced too.  It writes fp32
// partials (max m, sum l, unnormalized acc).  Pass 2 runs one block per query
// head and merges the partials by log-sum-exp into the normalized output and
// lse = m + log(l), which is what a kv-block split merges across its two
// streams.  The mask is positional (k_pos <= pos, and k_pos > pos - window
// when window > 0): the launcher turns it into one valid range, and blocks
// outside it write empty partials without reading the cache.  GQA heads are
// the rows of one KV head, unpadded.  Inputs are f32 or bf16; all arithmetic
// is fp32.  Vector loads, TMA and a split of hd across warps are later work.
#include "tiled_gemm.cuh"

#include <math.h>

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadTile = 8;   // query heads scored per pass over a K row
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Pass 1.  Grid (KV, nsb); partials are indexed [head][sb] (acc: [head][sb][d]).
// lo..hi is the valid position range; scale = 1 / sqrt(hd).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_partial(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ m_part,
             float* __restrict__ l_part, float* __restrict__ acc_part, int KV,
             int g, int hd, int bs, int lo, int hi, int nsb, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;           // (g, hd) query rows, pre-scaled
  float* ps = smem + g * hd;  // (g, bs) scores, then probabilities
  const int kvh = blockIdx.x, sb = blockIdx.y;
  const int s0 = sb * bs;
  const int first = max(s0, lo), last = min(s0 + bs, hi + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)KV * hd;  // elements from one position to the next
  const int h0 = kvh * g;

  if (first >= last) {  // the whole block is masked: an empty partial
    for (int e = threadIdx.x; e < g * hd; e += kThreads)
      acc_part[((long long)(h0 + e / hd) * nsb + sb) * hd + e % hd] = 0.f;
    for (int i = threadIdx.x; i < g; i += kThreads) {
      m_part[(long long)(h0 + i) * nsb + sb] = kNeg;
      l_part[(long long)(h0 + i) * nsb + sb] = 0.f;
    }
    return;
  }
  for (int e = threadIdx.x; e < g * hd; e += kThreads)
    qs[e] = to_f32(q[(long long)h0 * hd + e]) * scale;
  __syncthreads();

  // scores: a warp per position, kHeadTile heads per pass over the K row
  for (int s = first + warp; s < last; s += kWarps) {
    const T* kr = k + (long long)s * row + (long long)kvh * hd;
    for (int g0 = 0; g0 < g; g0 += kHeadTile) {
      const int gn = min(kHeadTile, g - g0);
      float part[kHeadTile];
#pragma unroll
      for (int i = 0; i < kHeadTile; ++i) part[i] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float kd = to_f32(kr[d]);
#pragma unroll
        for (int i = 0; i < kHeadTile; ++i)
          if (i < gn) part[i] = fmaf(qs[(g0 + i) * hd + d], kd, part[i]);
      }
#pragma unroll
      for (int i = 0; i < kHeadTile; ++i) {
        if (i < gn) {  // warp-uniform
          const float x = warp_sum(part[i]);
          if (lane == 0) ps[(g0 + i) * bs + (s - s0)] = x;
        }
      }
    }
  }
  __syncthreads();

  // the block's softmax over its valid positions, a warp per head
  const int n = last - first, off = first - s0;
  for (int i = warp; i < g; i += kWarps) {
    float* pr = ps + i * bs + off;
    float m = kNeg;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(pr[j] - m);
      pr[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_part[(long long)(h0 + i) * nsb + sb] = m;
      l_part[(long long)(h0 + i) * nsb + sb] = l;
    }
  }
  __syncthreads();

  // P @ V, threads along (head, hd)
  for (int e = threadIdx.x; e < g * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    const float* pr = ps + i * bs + off;
    const T* vc = v + (long long)first * row + (long long)kvh * hd + d;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) a = fmaf(pr[j], to_f32(vc[(long long)j * row]), a);
    acc_part[((long long)(h0 + i) * nsb + sb) * hd + d] = a;
  }
}

// Pass 2.  Grid (H): merge the nsb partials of one query head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
           const float* __restrict__ acc_part, T* __restrict__ out,
           float* __restrict__ lse, int nsb, int hd) {
  __shared__ float red[kWarps];
  const int h = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* mh = m_part + (long long)h * nsb;
  const float* lh = l_part + (long long)h * nsb;

  float m = kNeg;
  for (int j = threadIdx.x; j < nsb; j += kThreads) m = fmaxf(m, mh[j]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();

  float l = 0.f;
  for (int j = threadIdx.x; j < nsb; j += kThreads) l += expf(mh[j] - m) * lh[j];
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += red[w];

  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
    for (int j = 0; j < nsb; ++j)
      a = fmaf(expf(mh[j] - m), acc_part[((long long)h * nsb + j) * hd + d], a);
    out[(long long)h * hd + d] = from_f32<T>(a * inv);
  }
  if (threadIdx.x == 0) lse[h] = m + logf(l);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           void* m_part, void* l_part, void* acc_part, int H, int KV, int hd,
           int bs, int lo, int hi, int nsb, cudaStream_t stream) {
  const int g = H / KV;
  const size_t smem = sizeof(float) * (size_t)g * (hd + bs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attn_partial<T><<<dim3(KV, nsb), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), KV, g, hd,
      bs, lo, hi, nsb, 1.f / sqrtf(static_cast<float>(hd)));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_merge<T><<<H, kThreads, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out),
      static_cast<float*>(lse), nsb, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// device: the CUDA device of the operands and the stream.  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and out).  q (H, hd), k and v (S, KV, hd) and out
// (H, hd) are contiguous; lse (H) is float32.  m_part and l_part (H, nsb) and
// acc_part (H, nsb, hd) are float32 scratch with nsb = ceil(S / bs).  Valid
// positions are lo..hi (the caller has checked lo <= hi).  Returns the CUDA
// error code of the launches (0 = launched).
extern "C" int decode_attention_launch(int device, int dtype, const void* q,
                                       const void* k, const void* v, void* out,
                                       void* lse, void* m_part, void* l_part,
                                       void* acc_part, int H, int S, int KV,
                                       int hd, int bs, int lo, int hi,
                                       void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsb = (S + bs - 1) / bs;
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, m_part, l_part, acc_part, H, KV,
                         hd, bs, lo, hi, nsb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, lse, m_part, l_part, acc_part,
                                 H, KV, hd, bs, lo, hi, nsb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
