// ssd_chunk_scan: the Mamba2 SSD scan.  For every (batch, head) the (hd, N)
// state h is carried through T tokens,
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
// in fp32, for ~0.3 Mflop: bound by bytes, about 1.1 us at 3.35 TB/s, far
// below the few microseconds any launch takes from start to drain.  In
// chunked prefill (T in the thousands) it does ~(L + 2N) hd flops per token
// and head in shared memory and is bound by fp32 operations.
//
// Two kernels, chosen on the host per call (repro_torch/kernels/ssd_chunk/
// ssd_chunk.py: plan_ssd):
//
// `ssd_decode`, for T <= DECODE_T_MAX: the recurrence itself, which is exact
// and has no chunk machinery to pay for.  A block of 128 threads owns
// `rows` rows of one head's state; the `lanes` lanes of one row hold 8
// state values each in registers (N = 64: 8 lanes, 16 rows per block, four
// blocks per head, 448 blocks for the zamba2-7b step).  Each thread issues
// its 16-byte state loads first (streaming: the state is read once) and
// the load of a; the block stages its dt, B, C and x for the T tokens (a
// few hundred bytes at T = 1) in shared memory; then each thread steps the
// tokens in registers, h <- exp(dt a) h + (dt x_d) B_k, with
// y_d = sum_k C_k h_dk by a shuffle sum across the row's lanes.  It writes
// the final state once.  The state never touches shared memory, and the only
// barrier is the one after the operands are staged.  Where state0, the
// final state or the row pitch N * sizeof(T) is not 16-byte aligned, the same
// kernel loads and stores the state one element at a time.
//
// `ssd_chunk_kernel`, for longer T: one block per (batch, head) runs the
// chunk loop in order, so the state never leaves shared memory between
// chunks (this loop takes the place of the TPU's sequential grid axis).  Per
// chunk of L <= 64 tokens (the TPU's L = 256 would need a 256 KB (L, L)
// tile, over the 227 KB a block can have) it stages x * dt, B and C in
// shared memory, takes the cumulative sum l of dt * a, and computes, as the
// TPU kernel does,
//   y_t = exp(l_t) C_t . h0 + sum_{j <= t} exp(l_t - l_j) (C_t . B_j) dt_j x_j
//   h'  = exp(l_L) h0 + sum_j exp(l_L - l_j) dt_j x_j B_j^T.
// Rows of the state, B and C are padded by one word, so threads walking hd
// or the chunk read distinct shared-memory banks.  Global loads and stores
// run along hd or N, coalesced.  Tensor-core products for long prefill
// chunks are later work.
//
// Inputs are f32 or bf16; all arithmetic is fp32.
#include <cstdint>
#include <math.h>

#include "kernel_attrs.cuh"
#include "tiled_gemm.cuh"

namespace {

using repro_torch::configure_smem_once;
using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;          // chunk kernel
constexpr int kDecodeThreads = 128;    // decode kernel
constexpr int kLaneElems = 8;          // state values a decode lane holds

// variants, as the host plan names them
constexpr int kDecodeVector = 0, kDecodeScalar = 1, kChunk = 2;

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

// The column of slot e of the state values a lane holds, for a row held by
// `lanes` lanes: VEC, whole 16-byte chunks (lane, lane + lanes, ...);
// otherwise single elements lane, lane + lanes, ...
template <typename T, bool VEC>
__device__ __forceinline__ int state_col(int lane, int lanes, int e) {
  constexpr int CE = 16 / static_cast<int>(sizeof(T));
  return VEC ? (lane + lanes * (e / CE)) * CE + e % CE : lane + lanes * e;
}

// 16 bytes of T as floats, and back
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       __nv_bfloat16) {
  const unsigned int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // bf16 is the high half of an fp32
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned int pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&p);
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// The lane's state values of one row (zeros past N and on dead rows), every
// load issued before any is used.
template <typename T, bool VEC>
__device__ __forceinline__ void load_state(const T* __restrict__ row,
                                           int lane, int lanes, int N,
                                           bool live, float (&s)[kLaneElems]) {
  constexpr int CE = 16 / static_cast<int>(sizeof(T));
  if constexpr (VEC) {
    uint4 raw[kLaneElems / CE];
#pragma unroll
    for (int u = 0; u < kLaneElems / CE; ++u) {
      const int k0 = (lane + lanes * u) * CE;
      raw[u] = live && k0 < N
                   ? __ldcs(reinterpret_cast<const uint4*>(row + k0))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kLaneElems / CE; ++u) unpack(raw[u], s + u * CE, T());
  } else {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      const int k = lane + lanes * e;
      s[e] = live && k < N ? to_f32(row[k]) : 0.f;
    }
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_state(T* __restrict__ row, int lane,
                                            int lanes, int N,
                                            const float (&s)[kLaneElems]) {
  constexpr int CE = 16 / static_cast<int>(sizeof(T));
  if constexpr (VEC) {
#pragma unroll
    for (int u = 0; u < kLaneElems / CE; ++u) {
      const int k0 = (lane + lanes * u) * CE;
      if (k0 < N) *reinterpret_cast<uint4*>(row + k0) = pack(s + u * CE, T());
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      const int k = lane + lanes * e;
      if (k < N) row[k] = from_f32<T>(s[e]);
    }
  }
}

// Grid (B * H * ceil(hd / rows)), rows = kDecodeThreads / lanes: a block owns
// rows d0 .. d0 + rows - 1 of head h of batch bi, a row `lanes` lanes.
// Operands as for ssd_chunk_kernel.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kDecodeThreads)
ssd_decode(const T* __restrict__ x, const T* __restrict__ b,
           const T* __restrict__ c, const T* __restrict__ dt,
           const T* __restrict__ a, const T* __restrict__ state0,
           T* __restrict__ y, T* __restrict__ sf, int Tn, int H, int hd,
           int N, int lanes) {
  extern __shared__ float ops[];
  const int rows = kDecodeThreads / lanes;
  const int per_head = (hd + rows - 1) / rows;
  const int bh = blockIdx.x / per_head;          // bi * H + h
  const int d0 = (blockIdx.x % per_head) * rows;
  const int bi = bh / H, h = bh % H;
  const int r = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int d = d0 + r;
  const bool live = d < hd;
  const long long srow = ((long long)bh * hd + (live ? d : 0)) * N;

  float s[kLaneElems];
  load_state<T, VEC>(state0 + srow, lane, lanes, N, live, s);
  const float ah = to_f32(a[h]);

  // the T tokens' operands for this block's rows
  float* sdt = ops;              // (T)
  float* sb = sdt + Tn;          // (T, N)
  float* sc = sb + Tn * N;       // (T, N)
  float* sx = sc + Tn * N;       // (T, rows)
  for (int t = threadIdx.x; t < Tn; t += kDecodeThreads)
    sdt[t] = to_f32(dt[((long long)bi * Tn + t) * H + h]);
  for (int e = threadIdx.x; e < Tn * N; e += kDecodeThreads) {
    sb[e] = to_f32(b[(long long)bi * Tn * N + e]);
    sc[e] = to_f32(c[(long long)bi * Tn * N + e]);
  }
  for (int e = threadIdx.x; e < Tn * rows; e += kDecodeThreads) {
    const int t = e / rows, dd = d0 + e % rows;
    sx[e] = dd < hd ? to_f32(x[(((long long)bi * Tn + t) * H + h) * hd + dd])
                    : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    const float dtt = sdt[t];
    const float decay = expf(dtt * ah);
    const float xd = dtt * sx[t * rows + r];
    const float* bt = sb + t * N;
    const float* ct = sc + t * N;
    float yp = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      const int k = state_col<T, VEC>(lane, lanes, e);
      if (k < N) {
        s[e] = fmaf(decay, s[e], xd * bt[k]);
        yp = fmaf(ct[k], s[e], yp);
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1)
      yp += __shfl_xor_sync(0xffffffffu, yp, off);
    if (live && lane == 0)
      y[(((long long)bi * Tn + t) * H + h) * hd + d] = from_f32<T>(yp);
  }
  if (live) store_state<T, VEC>(sf + srow, lane, lanes, N, s);
}

template <typename T>
int launch(int device, const void* xv, const void* bv, const void* cv,
           const void* dtv, const void* av, const void* s0v, void* yv,
           void* sfv, int B, int Tn, int H, int hd, int N, int variant,
           int lanes, int L, int smem, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* b = static_cast<const T*>(bv);
  const T* c = static_cast<const T*>(cv);
  const T* dt = static_cast<const T*>(dtv);
  const T* a = static_cast<const T*>(av);
  const T* state0 = static_cast<const T*>(s0v);
  T* y = static_cast<T*>(yv);
  T* sf = static_cast<T*>(sfv);
  if (B < 1 || Tn < 1 || H < 1 || hd < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kChunk) {
    if (L < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int set = configure_smem_once<ssd_chunk_kernel<T>>(device);
    if (set != 0) return set;
    ssd_chunk_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
        x, b, c, dt, a, state0, y, sf, Tn, H, hd, N, L);
    return static_cast<int>(cudaGetLastError());
  }
  // the host plan, checked: a launch that does not match it is refused
  const bool aligned =
      reinterpret_cast<std::uintptr_t>(state0) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(sf) % 16 == 0 &&
      (static_cast<long long>(N) * sizeof(T)) % 16 == 0;
  const int rows = lanes > 0 ? kDecodeThreads / lanes : 0;
  const long long blocks =
      rows > 0 ? (long long)B * H * ((hd + rows - 1) / rows) : 0;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      lanes * kLaneElems < N || blocks > 0x7fffffffLL ||
      smem != 4 * Tn * (1 + 2 * N + rows) || smem > 48 * 1024 ||
      (variant == kDecodeVector && !aligned) ||
      (variant != kDecodeVector && variant != kDecodeScalar))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kDecodeVector)
    ssd_decode<T, true><<<static_cast<unsigned>(blocks), kDecodeThreads,
                          smem, stream>>>(x, b, c, dt, a, state0, y, sf, Tn,
                                          H, hd, N, lanes);
  else
    ssd_decode<T, false><<<static_cast<unsigned>(blocks), kDecodeThreads,
                           smem, stream>>>(x, b, c, dt, a, state0, y, sf, Tn,
                                           H, hd, N, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// device: the CUDA device of the operands and the stream.  dtype: 0 =
// float32, 1 = bfloat16, for every operand.  All operands are contiguous:
// x and y (B, T, H, hd), b and c (B, T, N), dt (B, T, H), a (H), state0 and
// sf (B, H, hd, N).  The plan (ssd_chunk.py: plan_ssd): variant 0 and 1 are
// the decode kernel with 16-byte and with scalar state loads, `lanes` lanes
// per state row and smem = 4 T (1 + 2 N + 128 / lanes) bytes; variant 2 is
// the chunk kernel with chunk length L and smem = 4 (hd (N+1) + L hd +
// 2 L (N+1) + L^2 + 4 L) bytes, which the caller has checked fits a block.
// Returns the CUDA error code of the launch.
extern "C" int ssd_chunk_launch(int device, int dtype, const void* x,
                                const void* b, const void* c, const void* dt,
                                const void* a, const void* state0, void* y,
                                void* sf, int B, int Tn, int H, int hd, int N,
                                int variant, int lanes, int L, int smem,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(device, x, b, c, dt, a, state0, y, sf, B, Tn, H, hd,
                         N, variant, lanes, L, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, x, b, c, dt, a, state0, y, sf, B,
                                 Tn, H, hd, N, variant, lanes, L, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
