// The Mamba2 mixer's pointwise work on either side of its SSD scan, in
// two kernels (kernels/mamba_mixer):
//
// - mamba_conv_silu: the depthwise causal conv over xBC with its bias and
//   SiLU, and softplus(dt + dt_bias), read straight from the in_proj
//   output and written group-major for the scan;
// - gated_rms_norm: the D skip, the SiLU(z) gate and the gated RMSNorm of
//   one group's heads, written in the model dtype into that group's
//   channels of the out_proj input.
//
// They replace no TPU kernel: the JAX package's mixer computes this work
// in plain code, and the port's plain version (`ref.py`) made some twenty
// passes over fp32 copies of it (a concatenation of the conv carry and
// xBC, its fp32 copy, one multiply-add pass per tap, the SiLU, one copy
// per group's scan operands, the concatenation of the groups' outputs and
// the norm's seven elementwise passes).
//
// One layout, the one every Zamba2 of the port has (the published widths
// and `Zamba2Layout.reduced()`): a 4-tap conv, and widths (conv_dim, the
// group's d_inner / G and N, P) in fours with rows and pointers 8-byte
// aligned, so one group's 4 channels never straddle two groups.  The
// launchers refuse any other.
//
// Bound on an H100: bytes.  Per token the conv reads xBC once in bf16 and
// writes xs, B and C once in fp32 (6 bytes a channel); the norm reads y
// and xs in fp32 and z in bf16 and writes bf16 (12 bytes a channel).  The
// arithmetic is a few operations a byte.
//
// Design:
// - the conv: one thread owns 4 channels (one 8-byte load a row) over a
//   run of `run` tokens of one sequence, holding the 4 taps' weights, the
//   bias and the last 3 rows in registers, so each input row is read
//   from device memory once (the K - 1 rows before a run are read again,
//   from L2, by the run before it); rows come in four at a time, loaded
//   before any is used.  A run's first rows come from the (B, 3,
//   conv_dim) carry where they lie before the sequence, so the carry is
//   never concatenated.  Each output goes to its group's contiguous rows,
//   (G, B, T, d_inner / G) for xs and (G, B, T, N) for B and C, so every
//   scan call's operands are dense and 16-byte aligned.  4 channels a
//   thread, at about half the registers of 8 (80 against 137), ran 20 %
//   faster than 8 on an H100 at 4 x 4096 tokens.  The threads past the conv channels compute dt,
//   (G, B, T, H / G).  Arithmetic as the plain version: in fp32, the first
//   tap times its weight plus the bias, then each later tap's product
//   added in order; SiLU x / (1 + exp(-x)); softplus log1p(exp(x)) below
//   20, x above.
// - the norm: one block a (token, group) row of d_inner / G channels: a
//   first pass forms v = (y + D[h] xs) silu(z) in fp32, four channels a
//   thread at a time, keeps v in shared memory and sums v^2; the block
//   reduces the sum; a second pass writes v rsqrt(mean + eps) gate, rounded
//   once to bf16.  y and xs are read as dense rows, z and the output by
//   their strides, so z is the in_proj output's slice and the output the
//   group's columns of the (B, T, d_inner) buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_attrs.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTaps = 4;                 // the conv's K
constexpr int kConvThreads = 128;
constexpr int kRowsAhead = 4;            // rows of a run loaded together
constexpr int kNormThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory, no opt-in
constexpr float kSoftplusThreshold = 20.f;

// 4 consecutive bf16 values as floats: one 8-byte load.
__device__ __forceinline__ void load_bf16(const bf16* p, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_f32(const float* p, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ void store_f32(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_bf16(bf16* p, const float (&v)[4]) {
  uint2 raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
  pairs[0] = __floats2bfloat162_rn(v[0], v[1]);
  pairs[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + expf(-x));
}

// ------------------------------------------------------------------ conv

struct ConvArgs {
  const bf16* xbc;       // (B, T, conv_dim) by (x_sb, x_st), dense rows
  const bf16* carry;     // (B, K - 1, conv_dim), contiguous
  const bf16* w;         // (K, conv_dim), contiguous
  const bf16* bias;      // (conv_dim,)
  const bf16* dt_raw;    // (B, T, H) by (d_sb, d_st), dense rows
  const float* dt_bias;  // (H,)
  float* xs;             // (G, B, T, d_inner / G)
  float* bm;             // (G, B, T, N)
  float* cm;             // (G, B, T, N)
  float* dt;             // (G, B, T, H / G)
  long long x_sb, x_st, d_sb, d_st;
  int b, t, conv_dim, d_inner, g, n, h, run, runs;
};

// The conv channels' threads: channels [c0, c0 + 4) of sequence bi over
// tokens [t0, t1).
__device__ __forceinline__ void conv_channels(const ConvArgs& a, int bi,
                                              int t0, int t1, int c0) {
  constexpr int K = kTaps;
  float w[K][4], bias[4];
#pragma unroll
  for (int i = 0; i < K; ++i)
    load_bf16(a.w + static_cast<long long>(i) * a.conv_dim + c0, w[i]);
  load_bf16(a.bias + c0, bias);

  // where channel c0 lands: its group's rows of xs, B or C
  const int dg = a.d_inner / a.g, gn = a.g * a.n;
  float* dst;
  int pitch;
  if (c0 < a.d_inner) {
    const int gi = c0 / dg;
    dst = a.xs + static_cast<long long>(gi * a.b + bi) * a.t * dg
          + (c0 - gi * dg);
    pitch = dg;
  } else {
    const int c = (c0 - a.d_inner) % gn, gi = c / a.n;
    dst = (c0 < a.d_inner + gn ? a.bm : a.cm)
          + static_cast<long long>(gi * a.b + bi) * a.t * a.n
          + (c - gi * a.n);
    pitch = a.n;
  }
  dst += static_cast<long long>(t0) * pitch;

  // the K - 1 rows before token t0: the carry's where t0 - K + 1 + i < 0
  const bf16* rows = a.xbc + bi * a.x_sb + c0;
  float win[K - 1][4];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int e = t0 + i - (K - 1);
    if (e < 0)
      load_bf16(a.carry + (static_cast<long long>(bi) * (K - 1) + K - 1 + e)
                              * a.conv_dim + c0, win[i]);
    else
      load_bf16(rows + e * a.x_st, win[i]);
  }

  for (int t = t0; t < t1; t += kRowsAhead) {
    float next[kRowsAhead][4];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      if (t + u < t1) {
        load_bf16(rows + (t + u) * a.x_st, next[u]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) next[u][v] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      if (t + u < t1) {
        float acc[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[v] = win[0][v] * w[0][v] + bias[v];
#pragma unroll
          for (int i = 1; i < K - 1; ++i) acc[v] += win[i][v] * w[i][v];
          acc[v] = silu(acc[v] + next[u][v] * w[K - 1][v]);
        }
        store_f32(dst, acc);
        dst += pitch;
#pragma unroll
        for (int i = 0; i + 1 < K - 1; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) win[i][v] = win[i + 1][v];
#pragma unroll
        for (int v = 0; v < 4; ++v) win[K - 2][v] = next[u][v];
      }
    }
  }
}

// The dt threads: heads [h0, h0 + 4) of sequence bi over tokens [t0, t1).
__device__ __forceinline__ void dt_heads(const ConvArgs& a, int bi, int t0,
                                         int t1, int h0) {
  const int hg = a.h / a.g;
  for (int t = t0; t < t1; ++t) {
    const bf16* src = a.dt_raw + bi * a.d_sb + t * a.d_st;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int hh = h0 + v;
      if (hh < a.h) {
        const float x = __bfloat162float(src[hh]) + a.dt_bias[hh];
        const int gi = hh / hg;
        a.dt[(static_cast<long long>(gi * a.b + bi) * a.t + t) * hg + hh
             - gi * hg] = x > kSoftplusThreshold ? x : log1pf(expf(x));
      }
    }
  }
}

// grid (B x runs, channel blocks): block x is one run of one sequence,
// thread j of the run's blockDim.y-th slice owns channels [4 j, 4 j + 4) of
// the conv, or past them, 4 heads of dt.
__global__ void __launch_bounds__(kConvThreads)
    mamba_conv_silu_fwd(const ConvArgs a) {
  const int bi = blockIdx.x / a.runs;
  const int t0 = (blockIdx.x % a.runs) * a.run;
  const int t1 = min(t0 + a.run, a.t);
  const int j = blockIdx.y * kConvThreads + threadIdx.x;
  const int vecs = a.conv_dim / 4;
  if (j < vecs)
    conv_channels(a, bi, t0, t1, j * 4);
  else if ((j - vecs) * 4 < a.h)
    dt_heads(a, bi, t0, t1, (j - vecs) * 4);
}

// ------------------------------------------------------------------ norm

struct NormArgs {
  const float* y;     // (B, T, dg), contiguous
  const float* xs;    // (B, T, dg), contiguous
  const bf16* z;      // (B, T, dg) by (z_sb, z_st), dense rows
  const float* d;     // (dg / P,): the group's heads' D
  const bf16* gate;   // (dg,)
  bf16* out;          // (B, T, dg) by (o_sb, o_st), dense rows
  long long z_sb, z_st, o_sb, o_st;
  int t, dg, p;
  float eps;
};

// One block a (token, group) row.
__global__ void __launch_bounds__(kNormThreads)
    gated_rms_norm_fwd(const NormArgs a) {
  extern __shared__ float vrow[];             // the row's v, dg floats
  __shared__ float partial[kNormThreads / 32];
  const int row = blockIdx.x, bi = row / a.t, ti = row % a.t;
  const float* y = a.y + static_cast<long long>(row) * a.dg;
  const float* xs = a.xs + static_cast<long long>(row) * a.dg;
  const bf16* z = a.z + bi * a.z_sb + ti * a.z_st;
  bf16* out = a.out + bi * a.o_sb + ti * a.o_st;

  float ss = 0.f;
  for (int c = threadIdx.x * 4; c < a.dg; c += kNormThreads * 4) {
    float yv[4], xv[4], zv[4];
    load_f32(y + c, yv);
    load_f32(xs + c, xv);
    load_bf16(z + c, zv);
    const float dh = a.d[c / a.p];            // 4 divides P
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float val = (yv[v] + dh * xv[v]) * silu(zv[v]);
      vrow[c + v] = val;
      ss += val * val;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < kNormThreads / 32 ? partial[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) partial[0] = s;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / a.dg + a.eps);

  // each thread reads back the v it wrote
  for (int c = threadIdx.x * 4; c < a.dg; c += kNormThreads * 4) {
    float gv[4], o[4];
    load_bf16(a.gate + c, gv);
#pragma unroll
    for (int v = 0; v < 4; ++v) o[v] = vrow[c + v] * r * gv[v];
    store_bf16(out + c, o);
  }
}

}  // namespace
}  // namespace repro_torch

// device: the CUDA device of the operands and the stream.  dtype: 1 =
// bfloat16 (xbc, carry, w, bias, dt_raw), the only one taken; dt_bias and
// the outputs are float32.  xbc (B, T, conv_dim) and dt_raw (B, T, H) by
// their (batch, token) strides in elements, rows dense; carry (B, K - 1,
// conv_dim), w (K, conv_dim), bias (conv_dim,), dt_bias (H,) and the
// outputs xs (G, B, T, d_inner / G), bm and cm (G, B, T, N) and dt (G, B,
// T, H / G) contiguous.  conv_dim = d_inner + 2 G N; G divides d_inner and
// H; K = 4; conv_dim, d_inner / G and N in fours, and xbc, carry, w, bias
// and xbc's rows 8-byte aligned.  run: tokens a thread walks.  Returns the
// CUDA error of the launch (0 = launched).
extern "C" int mamba_conv_silu_launch(
    int device, int dtype, const void* xbc, const void* carry,
    const void* w, const void* bias, const void* dt_raw,
    const void* dt_bias, void* xs, void* bm, void* cm, void* dt,
    long long x_sb, long long x_st, long long d_sb, long long d_st, int b,
    int t, int conv_dim, int d_inner, int g, int n, int h, int k, int run,
    void* stream) {
  using namespace repro_torch;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (dtype != 1 || k != kTaps || b < 1 || t < 1 || g < 1 || n < 1 ||
      h < 1 || run < 1 || d_inner % g || h % g ||
      conv_dim != d_inner + 2 * g * n || (d_inner / g) % 4 || n % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (t + run - 1) / run;
  const ConvArgs a{
      static_cast<const bf16*>(xbc), static_cast<const bf16*>(carry),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(dt_raw), static_cast<const float*>(dt_bias),
      static_cast<float*>(xs), static_cast<float*>(bm),
      static_cast<float*>(cm), static_cast<float*>(dt), x_sb, x_st, d_sb,
      d_st, b, t, conv_dim, d_inner, g, n, h, run, runs};
  const int threads = conv_dim / 4 + (h + 3) / 4;
  const dim3 grid(b * runs, (threads + kConvThreads - 1) / kConvThreads);
  mamba_conv_silu_fwd<<<grid, kConvThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// device, dtype (1 = bfloat16 for z, gate and out, the only one taken; y,
// xs and d float32).  y and xs (B, T, dg) contiguous, one group's scan
// output and conv output; z and out (B, T, dg) by their (batch, token)
// strides in elements, rows dense; d (dg / p,) and gate (dg,).  4 divides
// p and dg; y and xs 16-byte aligned, z, gate, out and their rows 8-byte
// aligned.  Returns the CUDA error of the launch (0 = launched).
extern "C" int gated_rms_norm_launch(
    int device, int dtype, const void* y, const void* xs, const void* z,
    const void* d, const void* gate, void* out, long long z_sb,
    long long z_st, long long o_sb, long long o_st, int b, int t, int dg,
    int p, float eps, void* stream) {
  using namespace repro_torch;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (dtype != 1 || b < 1 || t < 1 || p < 1 || dg % p || p % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const NormArgs a{static_cast<const float*>(y),
                   static_cast<const float*>(xs), static_cast<const bf16*>(z),
                   static_cast<const float*>(d),
                   static_cast<const bf16*>(gate), static_cast<bf16*>(out),
                   z_sb, z_st, o_sb, o_st, t, dg, p, eps};
  const int smem = dg * static_cast<int>(sizeof(float));
  if (smem > kDefaultSmem) {
    const int attr = configure_smem_once<gated_rms_norm_fwd>(device);
    if (attr != 0) return attr;
  }
  gated_rms_norm_fwd<<<b * t, kNormThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
