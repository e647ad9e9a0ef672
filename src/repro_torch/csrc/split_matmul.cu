// split_matmul: Y = X @ W[:, c0 : c0 + width], one group's share of a
// channel-split linear layer.
//
// Replaces the TPU kernel src/repro/kernels/split_matmul/split_matmul.py:
// split_matmul (body _split_matmul_kernel), a blocked MXU matmul over a
// (M/bm, W/bn, K/bk) grid with K innermost and an fp32 VMEM accumulator.
//
// Two designs, chosen on the host per call
// (repro_torch/kernels/split_matmul/split_matmul.py: plan_launch).
//
// M <= 8 (`splitk_gemv`).  The network's linear layers run at batch 1, so
// M = 1 and the product is a matrix-vector product that streams W once from
// device memory (2 flops per 4-byte weight).  It is bound by bytes: VGG16's
// first FC layer reads 25088 x 4096 x 4 B = 411 MB, a zamba2-7b decode step
// 2.2 GB over 39 launches.  What the design does about it:
// - Every byte of W is read once, 16 bytes per thread, as a streaming load
//   (ld.global.cs: evict-first in L2, so W does not push the activations
//   and partials out, nor force dirty lines back first).  A block owns a tile
//   of 32 x (16 / sizeof(T)) columns (128 fp32, 256 bf16): one warp reads
//   one row segment of the tile, 32 lanes x 16 bytes, fully coalesced.  The
//   block's 8 warps take different rows, each warp kUnroll rows at a time,
//   so every thread has kUnroll independent 16-byte loads in flight.
// - K is split across blocks so that the grid fills the card: the grid is
//   (column tiles) x (K splits).  The block's slice of X (up to 8 rows by
//   its K chunk) goes into shared memory once; each W value then feeds M
//   fused multiply-adds from registers.
// - The warps' partial sums meet in shared memory at the end of the block.
//   With one split the block writes Y; otherwise it writes fp32 partials
//   (splits, M, width) to a workspace, and `splitk_reduce` sums them in a
//   fixed order (splits strided over its warps, then the warps in order)
//   and rounds once to T.  It is a programmatic dependent launch that the
//   GEMV releases as its blocks start, so it is queued on the card while
//   the GEMV runs.  No atomics: the same inputs give a bit-identical Y on
//   every call.  (A last-block reduction through an arrival counter,
//   without the second launch, measured slower on the main-path shapes.)
// - The grid is one wave: the host asks the runtime how many GEMV blocks an
//   SM holds at once (split_matmul_resident) and splits K so that the
//   blocks fill those slots without a second, mostly empty wave.  Each warp
//   issues its first rows of W before the block stages X.
// - The 16-byte variant needs the slice's first column (w + c0) and the row
//   pitch (N * sizeof(T)) 16-byte aligned; otherwise the scalar variant of
//   the same kernel loads 4-byte (fp32) or 2-byte (bf16) elements, lane l
//   taking columns l, l + 32, ... so that a warp's loads stay coalesced.
//   Ragged width and K edges are masked; nothing is padded or copied.
//
// M > 8 (`tc_gemm`, the tiled product).  rwkv6-1.6b's 512-token prefill
// plan runs it at M = 512 on channel panels of K = 2048 and 4096: 2 M K
// flops per M K + K width + M width elements, ~200 flops a byte at width
// 400, so operations bound it.  Off the tensor cores (67 TFLOP/s of fp32
// FMA) that bound is 6.2 ms for one request's 98 launches; on them bf16
// runs at 989 TFLOP/s and fp32, as three TF32 products (3xTF32, below),
// at 495 / 3.  The SIMT product this replaces (64 x 64 blocks, scalar
// loads, two shared-memory loads per FMA, 5-7 blocks on a panel's narrow
// side) ran at 3-26 % of the fp32 bound.  What the design does:
// - Every product runs on the tensor cores with mma.sync.  bf16: m16n8k16
//   on bf16 operands into fp32 accumulators, the fragments loaded with
//   ldmatrix (W is (K, N) row-major, so its B fragments with .trans).
//   fp32: m16n8k8 in TF32 with the 3xTF32 split of ssd_chunk.cu
//   (tensor_core.cuh): each operand v = big + small, big = tf32(v) by
//   truncation, small = tf32(v - big), and acc += small big + big small +
//   big big, which keeps v to 2^-20 where one TF32 product (2^-10) misses
//   the 5e-5 the card holds fp32 to.  A warp splits each of its A
//   fragments once per k-step and uses it for all its column tiles, and
//   each B fragment for all its row tiles; the three products run in
//   passes over the warp's tiles, so neighbouring MMAs write different
//   accumulators.
// - A block of 8 warps owns a bm x bn tile of Y (64 or 128 each way; the
//   warp tiles 64 x 32 at 128 x 128) and walks its K chunk in kBK = 64-deep
//   steps through a ring of 3 shared-memory stages filled by 16-byte
//   cp.async copies: the next stages' X and W tiles are
//   in flight while the current one is multiplied, one barrier a step.
//   Tile rows are padded so that the fragment loads hit distinct banks
//   (fp32 X: 8 words, a half warp's 64-bit loads from 4 rows 8 banks apart;
//   fp32 W: 4 words, the rows 2t of a warp's scalar loads 8 banks apart;
//   bf16: 8 elements, ldmatrix's 8 row addresses in distinct 16-byte
//   groups).  Ragged M, N and K edges are zero-filled by copies with a
//   source size below 16 (0 past the edge); stores are masked.
// - Where X, W[0, c0] or a row pitch is not 16-byte aligned, the same
//   kernel's narrow variant stages with element loads (decided on the
//   actual pointers, as for the GEMV).  Its shared tiles, and so its sums,
//   are the same.
// - Fill the card, deterministically: the host picks the block and a K
//   split from the blocks an SM holds (split_matmul_tiled_resident) so
//   that the grid is about one wave; split chunks are whole kBK steps and
//   none is empty; a split grid writes fp32 partials to the workspace and
//   `splitk_reduce_rows` sums them in the GEMV's `splitk_reduce` order,
//   one thread per output.  Every output
//   is summed over its chunk in the same k order whatever its block, so a
//   block size changes no bit of Y once the split is fixed.
#include <cstdint>

#include "kernel_attrs.cuh"
#include "tensor_core.cuh"
#include "tiled_gemm.cuh"

namespace {

using repro_torch::configure_smem_once;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::FragA;
using repro_torch::FragB;
using repro_torch::from_f32;
using repro_torch::ld2;
using repro_torch::mma_tf32;
using repro_torch::store_pair;
using repro_torch::to_f32;

constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;              // rows of W in flight per thread

// variants, as the host plan names them
constexpr int kVector = 0, kScalar = 1, kTiled = 2, kTiledNarrow = 3;

// elements of T in 16 bytes: one lane's share of a row segment
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// the tile-local column of element e of lane `lane`
template <typename T, bool VEC>
__device__ __forceinline__ int local_col(int lane, int e) {
  return VEC ? lane * vec_elems<T>() + e : lane + 32 * e;
}

// 16 bytes of W as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // bf16 is the high half of an fp32
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// The lane's elements of one row of the block's tile, as raw bits: one
// 16-byte load, or vec_elems<T>() scalar loads masked on the width.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_row(const T* __restrict__ row,
                                          int tile0, int lane, int width) {
  constexpr int VN = vec_elems<T>();
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (VEC) {
    if (tile0 + lane * VN < width)
      raw = __ldcs(reinterpret_cast<const uint4*>(row + tile0 + lane * VN));
    return raw;
  }
  unsigned int words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VN; ++e) {
    const int col = tile0 + lane + 32 * e;
    if (col >= width) continue;
    if constexpr (sizeof(T) == 4) {
      words[e] = __ldcs(reinterpret_cast<const unsigned int*>(row + col));
    } else {
      const unsigned int h =
          __ldcs(reinterpret_cast<const unsigned short*>(row + col));
      words[e / 2] |= (e % 2) ? (h << 16) : h;
    }
  }
  raw.x = words[0];
  raw.y = words[1];
  raw.z = words[2];
  raw.w = words[3];
  return raw;
}

// Rows r0 .. r0 + kUnroll - 1 (those below len) of the block's chunk of W,
// all loads issued before any is used.
template <typename T, bool VEC>
__device__ __forceinline__ void load_rows(uint4 (&raw)[kUnroll],
                                          const T* __restrict__ w, int r0,
                                          int len, int n, int tile0,
                                          int lane, int width) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + u < len)
      raw[u] = load_row<T, VEC>(w + (long long)(r0 + u) * n, tile0, lane,
                                width);
  }
}

// One block: columns [tile0, tile0 + 32 * VN) of the slice, rows
// [kb, ke) of K, for the first m (<= MT) rows of X.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
splitk_gemv(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ y, float* __restrict__ ws, int m, int k, int n,
            int width, int k_chunk) {
  constexpr int VN = vec_elems<T>();
  constexpr int TILE = 32 * VN;
  extern __shared__ float xs[];               // [MT][k_chunk]
  __shared__ float red[kWarps][TILE];

  // the reduction pass may be queued now: it waits for this grid itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int kb = split * k_chunk;
  const int ke = min(k, kb + k_chunk);
  const int len = ke - kb;

  // the warp's first rows of W are in flight while X is staged
  uint4 raw[kUnroll];
  int r0 = warp * kUnroll;
  load_rows<T, VEC>(raw, w + (long long)kb * n, r0, len, n, tile0, lane,
                    width);
  for (int e = threadIdx.x; e < MT * k_chunk; e += kThreads) {
    const int i = e / k_chunk, r = e % k_chunk;
    xs[e] = (i < m && r < len) ? to_f32(x[(long long)i * k + kb + r]) : 0.f;
  }
  __syncthreads();

  float acc[MT][VN];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[i][e] = 0.f;

  while (r0 < len) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + u >= len) break;
      float wf[VN];
      unpack(raw[u], wf);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xv = xs[i * k_chunk + r0 + u];
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[i][e] = fmaf(xv, wf[e], acc[i][e]);
      }
    }
    r0 += kWarps * kUnroll;
    load_rows<T, VEC>(raw, w + (long long)kb * n, r0, len, n, tile0, lane,
                      width);
  }

  // the warps' partial sums, in warp order, one row of X at a time (m is
  // the same for the whole block, so every thread reaches each barrier)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= m) break;
#pragma unroll
    for (int e = 0; e < VN; ++e)
      red[warp][local_col<T, VEC>(lane, e)] = acc[i][e];
    __syncthreads();
    for (int c = threadIdx.x; c < TILE; c += kThreads) {
      const int col = tile0 + c;
      if (col < width) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) s += red[v][c];
        if (ws == nullptr)
          y[(long long)i * width + col] = from_f32<T>(s);
        else
          ws[((long long)split * m + i) * width + col] = s;
      }
    }
    __syncthreads();
  }
}

// Y = the sum of the splits' partials, rounded once to T.  A block owns 32
// columns of one row of Y; warp v sums splits v, v + kWarps, ... in order,
// and warp 0 adds the warps' sums in warp order: a fixed order, so the
// result is the same on every call.  Launched as a programmatic dependent
// of `splitk_gemv` on the same stream: it is queued while the GEMV runs,
// and waits here until the GEMV's partials are complete and visible.
template <typename T>
__global__ void __launch_bounds__(kThreads)
splitk_reduce(const float* __restrict__ ws, T* __restrict__ y, int m,
              int width, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float part[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane, i = blockIdx.y;
  float s = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int p = warp; p < splits; p += kWarps)
      s += ws[((long long)p * m + i) * width + col];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) t += part[v][lane];
    y[(long long)i * width + col] = from_f32<T>(t);
  }
}

// The same sums for the tiled product's grids, whose partials are M x
// width a split at M up to hundreds: one thread per output, which adds
// splits v, v + kWarps, ... in order for each v (splitk_reduce's warp v)
// and those sums in v order, the same operations in the same order as
// splitk_reduce, so the same bits.  (splitk_reduce's block per 32 columns
// of a row would make M width / 32 blocks: 32768 at 512 x 2048.)
template <typename T>
__global__ void __launch_bounds__(kThreads)
splitk_reduce_rows(const float* __restrict__ ws, T* __restrict__ y,
                   long long total, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  float t = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    float s = 0.f;
    for (int p = v; p < splits; p += kWarps) s += ws[p * total + e];
    t += s;
  }
  y[e] = from_f32<T>(t);
}

// Call f with the GEMV instantiation of (variant, mt); -1 if there is none.
template <typename T, typename F>
int with_gemv(int variant, int mt, F f) {
  if (variant != kVector && variant != kScalar) return -1;
  const bool vec = variant == kVector;
  switch (mt) {
    case 1: return vec ? f(splitk_gemv<T, 1, true>)
                       : f(splitk_gemv<T, 1, false>);
    case 2: return vec ? f(splitk_gemv<T, 2, true>)
                       : f(splitk_gemv<T, 2, false>);
    case 4: return vec ? f(splitk_gemv<T, 4, true>)
                       : f(splitk_gemv<T, 4, false>);
    case 8: return vec ? f(splitk_gemv<T, 8, true>)
                       : f(splitk_gemv<T, 8, false>);
  }
  return -1;
}

// The GEMV instantiation's shared-memory attributes, set once per device
// (kernel_attrs.cuh): never a runtime call per launch, so none inside a
// CUDA graph capture either.  -1 if there is no such instantiation.  The
// carveout stays the CUDA default: the largest shared-memory share measured
// ~1 % slower on the n18 GEMVs, whose X stage is at most 32 KB.
constexpr int kCarveout = cudaSharedmemCarveoutDefault;

template <typename T, int MT>
int configure_rows(int device, bool vec) {
  return vec
      ? configure_smem_once<splitk_gemv<T, MT, true>, kCarveout>(device)
      : configure_smem_once<splitk_gemv<T, MT, false>, kCarveout>(device);
}

template <typename T>
int configure(int device, int variant, int mt) {
  if (variant != kVector && variant != kScalar) return -1;
  const bool vec = variant == kVector;
  switch (mt) {
    case 1: return configure_rows<T, 1>(device, vec);
    case 2: return configure_rows<T, 2>(device, vec);
    case 4: return configure_rows<T, 4>(device, vec);
    case 8: return configure_rows<T, 8>(device, vec);
  }
  return -1;
}

// Y from the splits' fp32 partials in ws: `splitk_reduce` (the GEMV's) or
// `splitk_reduce_rows` (the tiled product's), launched as a programmatic
// dependent of the grid just launched on `stream`.
template <typename T>
int launch_reduce(const float* ws, T* y, int m, int width, int splits,
                  bool rows, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  const long long total = static_cast<long long>(m) * width;
  cfg.gridDim = rows ? dim3(static_cast<unsigned>((total + kThreads - 1) /
                                                  kThreads))
                     : dim3((width + 31) / 32, m);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      rows ? cudaLaunchKernelEx(&cfg, splitk_reduce_rows<T>, ws, y, total,
                                splits)
           : cudaLaunchKernelEx(&cfg, splitk_reduce<T>, ws, y, m, width,
                                splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_splitk(int device, const T* x, const T* wc, T* y, float* ws,
                  int m, int k, int n, int width, int variant, int mt,
                  int col_tiles, int splits, int k_chunk,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * mt * static_cast<size_t>(k_chunk);
  const int set = configure<T>(device, variant, mt);
  if (set != 0) return set < 0 ? static_cast<int>(cudaErrorInvalidValue)
                               : set;
  const int launched = with_gemv<T>(variant, mt, [&](auto kernel) {
    kernel<<<dim3(col_tiles, splits), kThreads, smem, stream>>>(
        x, wc, y, splits > 1 ? ws : nullptr, m, k, n, width, k_chunk);
    return static_cast<int>(cudaGetLastError());
  });
  if (launched < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (launched != 0 || splits == 1) return launched;
  return launch_reduce<T>(ws, y, m, width, splits, false, stream);
}

// ---- the tiled product (M > 8) on the tensor cores

constexpr int kGemmThreads = 256;       // 8 warps
constexpr int kBK = 64;                 // K rows of a ring stage, both types

// ring stages: 69 KB a stage in fp32 at 128 x 128, 35 KB in bf16, so two
// bf16 blocks share an SM
constexpr int kStages = 3;
// row pitches, in elements, of a stage's X tile (bm x kBK) and W tile
// (kBK x bn): padded so that the fragment loads hit distinct banks
constexpr int kXPitch = kBK + 8;
template <typename T, int BN>
__host__ __device__ constexpr int w_pitch() {
  return BN + (sizeof(T) == 4 ? 4 : 8);
}
// dynamic shared memory of a bm x bn block: the ring
template <typename T, int BM, int BN>
__host__ __device__ constexpr int gemm_smem() {
  return kStages * (BM * kXPitch + kBK * w_pitch<T, BN>()) *
         static_cast<int>(sizeof(T));
}

// The block's 8 warps as WM x WN, each owning a TM x TN tile of the block's
// bm x bn: MI x NI MMA tiles of 16 x 8
template <int BM, int BN>
struct WarpGrid {
  static constexpr int WM = (BM == 128 && BN == 64) ? 4 : 2;
  static constexpr int WN = kGemmThreads / 32 / WM;
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(MI * 16 == TM && NI * 8 == TN && NI % 2 == 0,
                "a warp tile is whole 16 x 16 pairs of MMA tiles");
};

// Copy the first `bytes` (0..16) of 16 bytes of global memory to shared
// memory, filling the rest with zeros (0: no read)
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes));
}

// Stage ROWS x COLS of a row-major global tile g (row stride ld elements)
// into shared memory s (row pitch SP), zero past nrows and ncols.  VEC:
// 16-byte cp.async copies (g and ld whole 16-byte chunks), a copy that
// crosses the ncols edge taking only its valid bytes; otherwise element
// loads.
template <typename T, bool VEC, int ROWS, int COLS, int SP>
__device__ __forceinline__ void stage_tile(T* s, const T* __restrict__ g,
                                           long long ld, int nrows,
                                           int ncols) {
  if constexpr (VEC) {
    constexpr int CE = 16 / static_cast<int>(sizeof(T));
    constexpr int PER_ROW = COLS / CE;
    constexpr int CHUNKS = ROWS * PER_ROW;
    static_assert(CHUNKS % kGemmThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < CHUNKS / kGemmThreads; ++i) {
      const int e = threadIdx.x + i * kGemmThreads;
      const int r = e / PER_ROW, c = (e % PER_ROW) * CE;
      const int left = r < nrows ? (ncols - c) * static_cast<int>(sizeof(T))
                                 : 0;
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      cp_async_n(s + r * SP + c, bytes > 0 ? g + r * ld + c : g, bytes);
    }
  } else {
    const T zero = from_f32<T>(0.f);
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * COLS; e += kGemmThreads) {
      const int r = e / COLS, c = e % COLS;
      s[r * SP + c] = (r < nrows && c < ncols) ? g[r * ld + c] : zero;
    }
  }
}

// One stage's kBK rows of K for a warp's MI x NI MMA tiles, fp32 in
// 3xTF32: xs at the warp's first row of the X tile, wt at its first column
// of the W tile.  Fragment slots t and t + 4 of a k-step take the
// neighbouring columns 2t and 2t + 1 (tensor_core.cuh), so a lane reads
// its two X values of a row with one 64-bit load.
template <int MI, int NI, int XP, int WP>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][NI][4],
                                          const float* xs, const float* wt,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    FragA a[MI];
    FragB b[NI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float2 lo = ld2(xs + (i * 16 + g) * XP + kk + 2 * t);
      const float2 hi = ld2(xs + (i * 16 + g + 8) * XP + kk + 2 * t);
      a[i].set(0, lo.x);
      a[i].set(1, hi.x);
      a[i].set(2, lo.y);
      a[i].set(3, hi.y);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      b[j].set(0, wt[(kk + 2 * t) * WP + j * 8 + g]);
      b[j].set(1, wt[(kk + 2 * t + 1) * WP + j * 8 + g]);
    }
    // small big, big small, then big big: every accumulator takes the
    // three in this order, in passes over the warp's tiles
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        mma_tf32(acc[i][j], a[i].small, b[j].big[0], b[j].big[1]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        mma_tf32(acc[i][j], a[i].big, b[j].small[0], b[j].small[1]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        mma_tf32(acc[i][j], a[i].big, b[j].big[0], b[j].big[1]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same in bf16: one m16n8k16 product a k-step.  Lanes 8q .. 8q + 7
// give ldmatrix the rows of its matrix q: for X the fragment's (rows 0-7 |
// 8-15) x (k 0-7 | 8-15); for W (.trans, k-major rows of 8 columns) the
// (k 0-7 | 8-15) halves of two neighbouring column tiles.
template <int MI, int NI, int XP, int WP>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][NI][4],
                                          const __nv_bfloat16* xs,
                                          const __nv_bfloat16* wt,
                                          int lane) {
  const int r8 = lane % 8, q = lane / 8;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[MI][4], b[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldmatrix_x4(a[i], xs + (i * 16 + (q % 2) * 8 + r8) * XP + kk +
                            (q / 2) * 8);
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, wt + (kk + (q % 2) * 8 + r8) * WP +
                               (j + q / 2) * 8);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// One block: the BM x BN tile (blockIdx.y, blockIdx.x) of Y over the K rows
// [kb, ke) of split blockIdx.z.  With ws == nullptr (one split) it writes
// Y, rounded once to T; otherwise fp32 partials ws[split][row][col].
// bf16 blocks are held to 128 registers a thread, so that two of them
// share an SM
template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kGemmThreads, sizeof(T) == 2 ? 2 : 1)
tc_gemm(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
        float* __restrict__ ws, int m, int k, int n, int width,
        int k_chunk) {
  using G = WarpGrid<BM, BN>;
  constexpr int S = kStages;
  constexpr int XP = kXPitch, WP = w_pitch<T, BN>();
  constexpr int XT = BM * XP, WT = kBK * WP;    // elements of a stage's tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);           // [S][BM][XP]
  T* wt = xs + S * XT;                          // [S][kBK][WP]

  // the reduction pass may be queued now: it waits for this grid itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int kb = split * k_chunk;
  const int len = min(k, kb + k_chunk) - kb;
  const int steps = len > 0 ? (len + kBK - 1) / kBK : 0;
  const T* xb = x + (long long)m0 * k + kb;
  const T* wb = w + (long long)kb * n + n0;
  auto load = [&](int step) {
    const int slot = step % S, k0 = step * kBK;
    stage_tile<T, VEC, BM, kBK, XP>(xs + slot * XT, xb + k0, k, m - m0,
                                    len - k0);
    stage_tile<T, VEC, kBK, BN, WP>(wt + slot * WT, wb + (long long)k0 * n,
                                    n, len - k0, width - n0);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % G::WM, wn = warp / G::WM;
  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int j = 0; j < G::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    // this step's stage has landed, and every warp is done with the one
    // the next copy overwrites
    cp_async_wait<S - 2>();
    __syncthreads();
    if (step + S - 1 < steps) load(step + S - 1);
    cp_async_commit();
    const int slot = step % S;
    mma_stage<G::MI, G::NI, XP, WP>(acc, xs + slot * XT + wm * G::TM * XP,
                                    wt + slot * WT + wn * G::TN, lane);
  }

  // the accumulators: c0, c1 at (g, 2t), (g, 2t + 1), c2, c3 eight rows on
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * G::TM + i * 16 + g + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < G::NI; ++j) {
        const int col = n0 + wn * G::TN + j * 8 + 2 * t;
        if (ws == nullptr)
          store_pair(y + (long long)row * width, col, width, acc[i][j][2 * h],
                     acc[i][j][2 * h + 1]);
        else
          store_pair(ws + ((long long)split * m + row) * width, col, width,
                     acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// One instantiation of the tiled product, for `with_tiled`
template <typename T, int BM, int BN, bool VEC>
struct Tiled {
  static constexpr int kSmem = gemm_smem<T, BM, BN>();
  static constexpr auto kernel = tc_gemm<T, BM, BN, VEC>;
  // its shared-memory limit raised once per device (kernel_attrs.cuh):
  // never a runtime call per launch, so none inside a graph capture
  static int configure(int device) {
    return configure_smem_once<tc_gemm<T, BM, BN, VEC>>(device);
  }
};

template <typename T, bool VEC, typename F>
int with_block(int bm, int bn, F f) {
  if (bm == 64 && bn == 64) return f(Tiled<T, 64, 64, VEC>());
  if (bm == 128 && bn == 64) return f(Tiled<T, 128, 64, VEC>());
  if (bm == 64 && bn == 128) return f(Tiled<T, 64, 128, VEC>());
  if (bm == 128 && bn == 128) return f(Tiled<T, 128, 128, VEC>());
  return -1;
}

// Call f with the tiled instantiation (variant, bm, bn); -1 if there is
// none
template <typename T, typename F>
int with_tiled(int variant, int bm, int bn, F f) {
  if (variant == kTiled) return with_block<T, true>(bm, bn, f);
  if (variant == kTiledNarrow) return with_block<T, false>(bm, bn, f);
  return -1;
}

template <typename T>
int launch_tiled(int device, const T* x, const T* wc, T* y, float* ws,
                 int m, int k, int n, int width, int variant, int bm, int bn,
                 int col_tiles, int splits, int k_chunk,
                 cudaStream_t stream) {
  const dim3 grid(col_tiles, (m + bm - 1) / bm, splits);
  const int launched = with_tiled<T>(variant, bm, bn, [&](auto blk) {
    using B = decltype(blk);
    const int set = B::configure(device);
    if (set != 0) return set;
    const auto kernel = B::kernel;
    kernel<<<grid, kGemmThreads, B::kSmem, stream>>>(
        x, wc, y, splits > 1 ? ws : nullptr, m, k, n, width, k_chunk);
    return static_cast<int>(cudaGetLastError());
  });
  if (launched < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (launched != 0 || splits == 1) return launched;
  return launch_reduce<T>(ws, y, m, width, splits, true, stream);
}

template <typename T>
int launch(int device, const void* xv, const void* wv, void* yv, void* wsv,
           int m, int k, int n, int c0, int width, int variant, int mt,
           int tile, int col_tiles, int splits, int k_chunk,
           cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* wc = static_cast<const T*>(wv) + c0;
  T* y = static_cast<T*>(yv);
  float* ws = static_cast<float*>(wsv);
  const bool w_aligned =
      reinterpret_cast<std::uintptr_t>(wc) % 16 == 0 &&
      (static_cast<long long>(n) * sizeof(T)) % 16 == 0;
  // the host plan, checked: a launch that does not match it is refused
  if (variant == kTiled || variant == kTiledNarrow) {
    // the block is mt x tile; split chunks are whole kBK steps, none empty
    const bool aligned =
        w_aligned && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
        (static_cast<long long>(k) * sizeof(T)) % 16 == 0;
    if (m <= 8 || tile < 1 || col_tiles != (width + tile - 1) / tile ||
        k_chunk < kBK || k_chunk % kBK != 0 ||
        splits != max(1, (k + k_chunk - 1) / k_chunk) ||
        (splits > 1 && ws == nullptr) || (variant == kTiled && !aligned))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tiled<T>(device, x, wc, y, ws, m, k, n, width, variant, mt,
                           tile, col_tiles, splits, k_chunk, stream);
  }
  if (m < 1 || m > mt || tile != 32 * vec_elems<T>() ||
      col_tiles != (width + tile - 1) / tile ||
      k_chunk < 1 || splits != max(1, (k + k_chunk - 1) / k_chunk) ||
      (splits > 1 && ws == nullptr) || (variant == kVector && !w_aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_splitk<T>(device, x, wc, y, ws, m, k, n, width, variant, mt,
                          col_tiles, splits, k_chunk, stream);
}

template <typename T>
int resident(int device, int variant, int mt, int smem) {
  // with the attributes the launches run with (the carveout sets the
  // shared memory an SM offers)
  const int set = configure<T>(device, variant, mt);
  if (set != 0) return set < 0 ? -static_cast<int>(cudaErrorInvalidValue)
                               : -set;
  int blocks = 0;
  const int found = with_gemv<T>(variant, mt, [&](auto kernel) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, smem));
  });
  if (found < 0) return -static_cast<int>(cudaErrorInvalidValue);
  return found == 0 ? blocks : -found;
}

template <typename T>
int tiled_resident(int device, int variant, int bm, int bn) {
  int blocks = 0;
  const int found = with_tiled<T>(variant, bm, bn, [&](auto blk) {
    using B = decltype(blk);
    const int set = B::configure(device);
    if (set != 0) return set;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, B::kernel, kGemmThreads, B::kSmem));
  });
  if (found < 0) return -static_cast<int>(cudaErrorInvalidValue);
  return found == 0 ? blocks : -found;
}

}  // namespace

// device: the CUDA device the operands and the stream belong to.
// dtype: 0 = float32, 1 = bfloat16.  x (m, k) and w (k, n) are row-major
// and contiguous; y (m, width) is written row-major.  ws: an fp32
// workspace of splits * m * width values (unused with one split).  The
// launch plan (variant 0 = 16-byte loads, 1 = scalar loads, 2 = the tiled
// product for m > 8 with 16-byte cp.async staging, 3 = the same with
// element loads; mt, the rows of X a block holds; tile, its columns;
// col_tiles; splits; k_chunk, the rows of K per split) comes from the host
// planner.  Returns the CUDA error code of the launches (0 = launched).
// Blocks of the GEMV instantiation (dtype, variant, mt) that one SM holds
// at once with `smem` bytes of dynamic shared memory: the host plan sizes
// the grid to one wave of them.  Negative: minus a CUDA error code.
extern "C" int split_matmul_resident(int device, int dtype, int variant,
                                     int mt, int smem) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return -static_cast<int>(set);
  if (dtype == 0) return resident<float>(device, variant, mt, smem);
  if (dtype == 1)
    return resident<__nv_bfloat16>(device, variant, mt, smem);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the tiled instantiation (dtype, variant, bm x bn) that one SM
// holds at once, its shared-memory limit set first.  Negative: minus a
// CUDA error code.
extern "C" int split_matmul_tiled_resident(int device, int dtype,
                                           int variant, int bm, int bn) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return -static_cast<int>(set);
  if (dtype == 0) return tiled_resident<float>(device, variant, bm, bn);
  if (dtype == 1)
    return tiled_resident<__nv_bfloat16>(device, variant, bm, bn);
  return -static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int split_matmul_launch(int device, int dtype, const void* x,
                                   const void* w, void* y, void* ws, int m,
                                   int k, int n, int c0, int width,
                                   int variant, int mt, int tile,
                                   int col_tiles, int splits, int k_chunk,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(device, x, w, y, ws, m, k, n, c0, width, variant,
                         mt, tile, col_tiles, splits, k_chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, x, w, y, ws, m, k, n, c0, width,
                                 variant, mt, tile, col_tiles, splits,
                                 k_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
