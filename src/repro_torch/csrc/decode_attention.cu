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
// 3.35 TB/s.  To reach that rate each SM must keep tens of KB of loads in
// flight.
//
// What the design does about it:
// - Only the attended positions lo..hi are read (the mask is positional:
//   k_pos <= pos, and k_pos > pos - window when window > 0).  The host cuts
//   them into nsplit runs of whole kTile-position tiles per KV head
//   (repro_torch/kernels/decode_attention/decode_attention.py:
//   plan_attention), so that the KV x nsplit blocks of pass 1, `attn_runs`,
//   are one wave of the blocks the card holds at once
//   (decode_attention_resident asks the runtime).  No block is launched
//   over masked positions and none has an empty run.
// - A block streams its run through a ring of kStages tiles of K and V
//   (kTile positions x hd each) in shared memory, filled with 16-byte
//   cp.async copies: while one tile is scored, the next kStages - 1 are in
//   flight, ~57 KB per fp32 block at hd = 112, with an L2 evict-first
//   policy (the cache is read once).  (TMA would need a tensor map
//   encoded on the host for every call, cuTensorMapEncodeTiled, for copies
//   that cp.async already issues 16 bytes per thread.)  Rows past the
//   run's end are zero-filled by the copy; rows are padded to whole 16-byte
//   chunks with zeros.
// - Scores come from shared memory: a warp per position, the lanes over
//   16-byte chunks of hd, a shuffle sum per (position, head).  The block
//   keeps an online softmax across its tiles, as the TPU kernel does along
//   its sequential S axis: (max, sum) per query head in shared memory, the
//   unnormalized P @ V in registers, threads over (head, chunk of hd) and
//   the tile's positions split among the threads left over.  At the run's
//   end the threads' sums meet in the ring's memory in a fixed order.
// - Pass 2, `attn_merge`, adds the runs' partials in a fixed order and
//   writes out and lse = m + log(l), so two calls on the same inputs give
//   bit-identical results.  It is a programmatic dependent launch that pass
//   1 releases as its blocks start: it is queued on the card while pass 1
//   runs.
// - Where K, V, the row pitch KV * hd * sizeof(T) or hd * sizeof(T) is not
//   16-byte aligned, the same kernel fills the ring with scalar loads.
// Inputs are f32 or bf16; all arithmetic is fp32.
#include <cstdint>
#include <math.h>

#include "kernel_attrs.cuh"
#include "tiled_gemm.cuh"

namespace {

using repro_torch::configure_smem_once;
using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kTile = 32;        // cache positions per tile (a lane each)
constexpr int kStages = 3;       // tiles in the ring
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kMaxItems = 4;     // (head, chunk of hd) pairs per thread
constexpr int kMergeThreads = 128;
constexpr float kNeg = -1e30f;

// variants, as the host plan names them
constexpr int kVector = 0, kScalar = 1;

// elements of T in one 16-byte chunk
template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// Dynamic shared memory of a pass-1 block; the host plan computes the same
// (decode_attention.py: attn_smem).
template <typename T>
size_t smem_bytes(int g, int chunks) {
  const size_t ring = static_cast<size_t>(kStages) * 2 * kTile * chunks * 16;
  const size_t red = static_cast<size_t>(kThreads) * chunk_elems<T>() * 4;
  return (ring > red ? ring : red) +
         4 * static_cast<size_t>(g) * (chunks * chunk_elems<T>() + kTile + 3);
}

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

// An L2 policy that evicts the lines it touches first: the cache is read
// once, so it should not push other data out of L2 (nor force dirty lines
// back to memory to make room).
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid,
                                           unsigned long long policy) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;       // 0: fill the 16 bytes with zeros
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      :: "r"(dst), "l"(gmem), "r"(bytes), "l"(policy));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// one 16-byte chunk of a shared-memory row as floats
__device__ __forceinline__ void unpack(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // bf16 is the high half of an fp32
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// VE consecutive fp32 values of shared memory
template <int VE>
__device__ __forceinline__ void load_floats(const float* p, float (&f)[VE]) {
#pragma unroll
  for (int i = 0; i < VE; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    f[i] = v.x;
    f[i + 1] = v.y;
    f[i + 2] = v.z;
    f[i + 3] = v.w;
  }
}

// Fill one ring slot with the K and V rows of positions t0 .. t0 + kTile - 1
// (zeros from `end` on) of one KV head: `kh`, `vh` point at the head's
// first element, rows are `row` elements apart; a slot row holds `chunks`
// 16-byte chunks, zero past hd.  VEC: the thread copies chunks
// e = threadIdx.x, + kThreads, ..., chunk e being (row j, chunk c) with
// j0 / c0 the first and dj / dc the step, carried without a division.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_tile(T* ks, T* vs,
                                           const T* __restrict__ kh,
                                           const T* __restrict__ vh,
                                           long long row, int hd, int chunks,
                                           int t0, int end, int j0, int c0,
                                           int dj, int dc,
                                           unsigned long long policy) {
  constexpr int VE = chunk_elems<T>();
  if constexpr (VEC) {
    int j = j0, c = c0;
    for (int e = threadIdx.x; e < kTile * chunks; e += kThreads) {
      const bool ok = t0 + j < end;
      const long long off = ok ? (long long)(t0 + j) * row + c * VE : 0;
      cp_async16(ks + e * VE, kh + off, ok, policy);
      cp_async16(vs + e * VE, vh + off, ok, policy);
      j += dj;
      c += dc;
      if (c >= chunks) {
        c -= chunks;
        ++j;
      }
    }
  } else {
    const int width = chunks * VE;
    for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
      const int j = e / width, d = e % width;
      const bool ok = t0 + j < end && d < hd;
      const long long off = (long long)(t0 + j) * row + d;
      ks[e] = ok ? kh[off] : from_f32<T>(0.f);
      vs[e] = ok ? vh[off] : from_f32<T>(0.f);
    }
  }
}

// Pass 1.  Grid (KV, nsplit): block (kvh, r) attends positions
// [lo + r * run_len, min(hi + 1, lo + (r + 1) * run_len)) for the g query
// heads of KV head kvh.  It writes the run's partials indexed [head][r]
// (acc: [head][r][d]).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
attn_runs(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, float* __restrict__ m_part,
          float* __restrict__ l_part, float* __restrict__ acc_part, int KV,
          int g, int hd, int lo, int hi, int run_len, int nsplit, int chunks,
          float scale) {
  constexpr int VE = chunk_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  // the merge may be queued now: it waits for this grid itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int width = chunks * VE;              // a slot row, in elements
  const int tile_elems = kTile * width;
  const int ring_bytes = max(kStages * 2 * tile_elems *
                                 static_cast<int>(sizeof(T)),
                             kThreads * VE * 4);
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + ring_bytes);  // (g, width)
  float* ps = qs + g * width;                 // (g, kTile) scores, then p
  float* ms = ps + g * kTile;                 // (g) running max
  float* ls = ms + g;                         // (g) running sum
  float* al = ls + g;                         // (g) this tile's rescale

  const int kvh = blockIdx.x, run = blockIdx.y;
  const int begin = lo + run * run_len;
  const int end = min(hi + 1, begin + run_len);
  const int ntiles = (end - begin + kTile - 1) / kTile;
  const long long row = (long long)KV * hd;
  const T* kh = k + (long long)kvh * hd;
  const T* vh = v + (long long)kvh * hd;
  const int h0 = kvh * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = threadIdx.x / chunks, c0 = threadIdx.x % chunks;
  const int dj = kThreads / chunks, dc = kThreads % chunks;
  const unsigned long long policy = evict_first_policy();

  // the first tiles are in flight while the queries are staged
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles)
      stage_tile<T, VEC>(ring + st * 2 * tile_elems,
                         ring + st * 2 * tile_elems + tile_elems, kh, vh,
                         row, hd, chunks, begin + st * kTile, end, j0, c0,
                         dj, dc, policy);
    cp_async_commit();
  }
  for (int e = threadIdx.x; e < g * width; e += kThreads) {
    const int i = e / width, d = e % width;
    qs[e] = d < hd ? to_f32(q[(long long)(h0 + i) * hd + d]) * scale : 0.f;
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    ms[i] = kNeg;
    ls[i] = 0.f;
  }

  // this thread's share of P @ V: items (head, chunk) t % items,
  // t % items + kThreads, ..., over positions sub, sub + nsub, ...
  const int items = g * chunks;
  const int nsub = max(1, kThreads / items);
  const int sub = threadIdx.x / items;
  const bool active = sub < nsub;
  float acc[kMaxItems][VE];
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[u][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();      // tile t has landed; tile t - 1's slot is free
    const int next = t + kStages - 1;
    if (next < ntiles) {
      T* slot = ring + (next % kStages) * 2 * tile_elems;
      stage_tile<T, VEC>(slot, slot + tile_elems, kh, vh, row, hd, chunks,
                         begin + next * kTile, end, j0, c0, dj, dc, policy);
    }
    cp_async_commit();
    const T* kt = ring + (t % kStages) * 2 * tile_elems;
    const T* vt = kt + tile_elems;
    const int t0 = begin + t * kTile;

    // scores: a warp per position, the lanes over chunks of hd
    for (int i = 0; i < g; ++i) {
      float part[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) part[r] = 0.f;
      for (int c = lane; c < chunks; c += 32) {
        float qv[VE];
        load_floats<VE>(qs + i * width + c * VE, qv);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          float kf[VE];
          unpack(kt + (warp + r * kWarps) * width + c * VE, kf);
#pragma unroll
          for (int e = 0; e < VE; ++e) part[r] = fmaf(qv[e], kf[e], part[r]);
        }
      }
      float mine = 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float s = warp_sum(part[r]);
        if (lane == r) mine = s;
      }
      if (lane < kRowsPerWarp) {
        const int j = warp + lane * kWarps;
        ps[i * kTile + j] = t0 + j < end ? mine : kNeg;
      }
    }
    __syncthreads();

    // online softmax: a warp per query head, a lane per position
    for (int i = warp; i < g; i += kWarps) {
      const float s = ps[i * kTile + lane];
      const float m_old = ms[i];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      ps[i * kTile + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        al[i] = a;
        ls[i] = fmaf(ls[i], a, sum);
        ms[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * rescale + P @ V
    if (active) {
#pragma unroll
      for (int u = 0; u < kMaxItems; ++u) {
        const int item = threadIdx.x % items + u * kThreads;
        if (item >= items) break;
        const int i = item / chunks, c = item % chunks;
        const float a = al[i];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[u][e] *= a;
        for (int j = sub; j < kTile; j += nsub) {
          const float p = ps[i * kTile + j];
          float vf[VE];
          unpack(vt + j * width + c * VE, vf);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[u][e] = fmaf(p, vf[e], acc[u][e]);
        }
      }
    }
  }

  // the threads' sums of one item meet in the ring's memory, in sub order
  cp_async_wait<0>();
  __syncthreads();
  bool writer = active;
  if (nsub > 1) {
    float* red = reinterpret_cast<float*>(smem);
    if (active) {
#pragma unroll
      for (int e = 0; e < VE; ++e)
        red[(sub * items + threadIdx.x % items) * VE + e] = acc[0][e];
    }
    __syncthreads();
    writer = threadIdx.x < items;
    if (writer) {
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[0][e] = red[threadIdx.x * VE + e];
      for (int s = 1; s < nsub; ++s)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          acc[0][e] += red[(s * items + threadIdx.x) * VE + e];
    }
  }
  if (!writer) return;
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    const int item = threadIdx.x % items + u * kThreads;
    if (item >= items) break;
    const int i = item / chunks, c = item % chunks;
    const long long hr = (long long)(h0 + i) * nsplit + run;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int d = c * VE + e;
      if (d >= hd) break;
      acc_part[hr * hd + d] = acc[u][e];
    }
    if (c == 0) {
      m_part[hr] = ms[i];
      l_part[hr] = ls[i];
    }
  }
}

// Pass 2.  Grid (H): merge one query head's nsplit partials, in run order.
// Launched as a programmatic dependent of `attn_runs` on the same stream:
// queued while pass 1 runs, it waits here until the partials are complete
// and visible.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
attn_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
           const float* __restrict__ acc_part, T* __restrict__ out,
           float* __restrict__ lse, int nsplit, int hd) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ float wts[];            // (nsplit) exp(m_r - m)
  __shared__ float red[kMergeThreads / 32];
  __shared__ float total;
  const int h = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* mh = m_part + (long long)h * nsplit;
  const float* lh = l_part + (long long)h * nsplit;

  float m = kNeg;
  for (int r = threadIdx.x; r < nsplit; r += kMergeThreads)
    m = fmaxf(m, mh[r]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) m = fmaxf(m, red[w]);
  for (int r = threadIdx.x; r < nsplit; r += kMergeThreads)
    wts[r] = expf(mh[r] - m);
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int r = 0; r < nsplit; ++r) l = fmaf(wts[r], lh[r], l);
    total = l;
    lse[h] = m + logf(l);
  }
  __syncthreads();
  const float inv = 1.f / total;
  for (int d = threadIdx.x; d < hd; d += kMergeThreads) {
    const float* ad = acc_part + (long long)h * nsplit * hd + d;
    float a = 0.f;
#pragma unroll 4
    for (int r = 0; r < nsplit; ++r) a = fmaf(wts[r], ad[(long long)r * hd], a);
    out[(long long)h * hd + d] = from_f32<T>(a * inv);
  }
}

// Call f with the pass-1 instantiation of `variant`; -1 if there is none.
template <typename T, typename F>
int with_runs(int variant, F f) {
  if (variant == kVector) return f(attn_runs<T, true>);
  if (variant == kScalar) return f(attn_runs<T, false>);
  return -1;
}

template <typename T>
int configure(int device, int variant) {
  if (variant == kVector)
    return configure_smem_once<attn_runs<T, true>>(device);
  if (variant == kScalar)
    return configure_smem_once<attn_runs<T, false>>(device);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(int device, const void* qv, const void* kv_, const void* vv,
           void* outv, void* lsev, void* m_part, void* l_part,
           void* acc_part, int H, int KV, int hd, int lo, int hi,
           int variant, int run_len, int nsplit, int chunks, int smem,
           int tile, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv_);
  const T* v = static_cast<const T*>(vv);
  T* out = static_cast<T*>(outv);
  float* lse = static_cast<float*>(lsev);
  // the host plan, checked: a launch that does not match it is refused
  const int n = hi - lo + 1;
  if (KV < 1 || hd < 1 || H % KV || lo < 0 || n < 1 || tile != kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / KV;
  const bool aligned =
      reinterpret_cast<std::uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(v) % 16 == 0 &&
      (static_cast<long long>(KV) * hd * sizeof(T)) % 16 == 0 &&
      (static_cast<long long>(hd) * sizeof(T)) % 16 == 0;
  if (run_len < kTile || run_len % kTile ||
      nsplit != (n + run_len - 1) / run_len || nsplit > 65535 ||
      chunks != (hd * static_cast<int>(sizeof(T)) + 15) / 16 ||
      g * chunks > kMaxItems * kThreads ||
      static_cast<size_t>(smem) != smem_bytes<T>(g, chunks) ||
      (variant == kVector && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  const int set = configure<T>(device, variant);
  if (set != 0) return set;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int launched = with_runs<T>(variant, [&](auto kernel) {
    kernel<<<dim3(KV, nsplit), kThreads, smem, stream>>>(
        q, k, v, static_cast<float*>(m_part),
        static_cast<float*>(l_part), static_cast<float*>(acc_part), KV, g,
        hd, lo, hi, run_len, nsplit, chunks, scale);
    return static_cast<int>(cudaGetLastError());
  });
  if (launched < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (launched != 0) return launched;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = sizeof(float) * static_cast<size_t>(nsplit);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, attn_merge<T>, static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<const float*>(acc_part),
      out, lse, nsplit, hd);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident(int device, int variant, int smem) {
  const int set = configure<T>(device, variant);
  if (set != 0) return -set;
  int blocks = 0;
  const int found = with_runs<T>(variant, [&](auto kernel) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, smem));
  });
  if (found < 0) return -static_cast<int>(cudaErrorInvalidValue);
  return found == 0 ? blocks : -found;
}

}  // namespace

// Pass-1 blocks of the instantiation (dtype, variant) that one SM holds at
// once with `smem` bytes of dynamic shared memory: the host plan sizes the
// grid to one wave of them.  Negative: minus a CUDA error code.
extern "C" int decode_attention_resident(int device, int dtype, int variant,
                                         int smem) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return -static_cast<int>(set);
  if (dtype == 0) return resident<float>(device, variant, smem);
  if (dtype == 1) return resident<__nv_bfloat16>(device, variant, smem);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// device: the CUDA device of the operands and the stream.  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and out).  q (H, hd), k and v (S, KV, hd) and out
// (H, hd) are contiguous; lse (H) is float32.  m_part and l_part
// (H, nsplit) and acc_part (H, nsplit, hd) are float32 scratch.  The
// plan (decode_attention.py: plan_attention): valid positions lo..hi, cut
// into nsplit runs of run_len positions (a multiple of tile = 32); variant
// 0 = 16-byte copies, 1 = scalar copies; chunks = 16-byte chunks per row of
// hd; smem = pass 1's dynamic shared memory.  Returns the CUDA error code
// of the launches (0 = launched).
extern "C" int decode_attention_launch(int device, int dtype, const void* q,
                                       const void* k, const void* v, void* out,
                                       void* lse, void* m_part, void* l_part,
                                       void* acc_part, int H, int KV, int hd,
                                       int lo, int hi, int variant,
                                       int run_len, int nsplit, int chunks,
                                       int smem, int tile, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(device, q, k, v, out, lse, m_part, l_part, acc_part,
                         H, KV, hd, lo, hi, variant, run_len, nsplit, chunks,
                         smem, tile, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, q, k, v, out, lse, m_part, l_part,
                                 acc_part, H, KV, hd, lo, hi, variant,
                                 run_len, nsplit, chunks, smem, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
