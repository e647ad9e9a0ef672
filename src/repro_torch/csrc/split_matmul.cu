// split_matmul: Y = X @ W[:, c0 : c0 + width], one group's share of a
// channel-split linear layer.
//
// Replaces the TPU kernel src/repro/kernels/split_matmul/split_matmul.py:
// split_matmul (body _split_matmul_kernel), a blocked MXU matmul over a
// (M/bm, W/bn, K/bk) grid with K innermost and an fp32 VMEM accumulator.
//
// What bounds it on an H100: the network's linear layers run at batch 1, so
// M = 1 and the product is a matrix-vector product that streams W once from
// device memory (2 flops per 4-byte weight).  It is bound by bytes: VGG16's
// first FC layer reads 25088 x 4096 x 4 B = 411 MB, a zamba2-7b decode step
// 2.2 GB over 39 launches.
//
// What the design does about it (M <= 8, `splitk_gemv`):
// - Every byte of W is read once, 16 bytes per thread, as a streaming load
//   (ld.global.cs: evict-first in L2, so W does not push the activations
//   and partials out, nor force dirty lines back first).  A block owns a tile
//   of 32 x (16 / sizeof(T)) columns (128 fp32, 256 bf16): one warp reads
//   one row segment of the tile, 32 lanes x 16 bytes, fully coalesced.  The
//   block's 8 warps take different rows, each warp kUnroll rows at a time,
//   so every thread has kUnroll independent 16-byte loads in flight.
// - K is split across blocks so that the grid fills the card: the grid is
//   (column tiles) x (K splits), planned on the host
//   (repro_torch/kernels/split_matmul/split_matmul.py: plan_launch).  The
//   block's slice of X (up to 8 rows by its K chunk) goes into shared memory
//   once; each W value then feeds M fused multiply-adds from registers.
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
// M > 8 is off the main paths and keeps the shared-memory tiled product
// (64 x 64 tile, 4 x 4 outputs per thread, tiled_gemm.cuh).
#include <cstdint>

#include "kernel_attrs.cuh"
#include "tiled_gemm.cuh"

namespace {

using repro_torch::configure_smem_once;
using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;              // rows of W in flight per thread

// variants, as the host plan names them
constexpr int kVector = 0, kScalar = 1, kTiled = 2;

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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((width + 31) / 32, m);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, splitk_reduce<T>, static_cast<const float*>(ws), y, m, width,
      splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int device, const void* xv, const void* wv, void* yv, void* wsv,
           int m, int k, int n, int c0, int width, int variant, int mt,
           int col_tiles, int splits, int k_chunk, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* wc = static_cast<const T*>(wv) + c0;
  T* y = static_cast<T*>(yv);
  float* ws = static_cast<float*>(wsv);
  if (variant == kTiled) {
    return repro_torch::launch_tiled_gemm<T, 64, 64, 16, 4, 4>(
        x, wc, y, 1, m, width, k, k, n, width, 0, 0, 0, stream);
  }
  // the host plan, checked: a launch that does not match it is refused
  constexpr int tile = 32 * vec_elems<T>();
  const bool aligned =
      reinterpret_cast<std::uintptr_t>(wc) % 16 == 0 &&
      (static_cast<long long>(n) * sizeof(T)) % 16 == 0;
  if (m < 1 || m > mt || col_tiles != (width + tile - 1) / tile ||
      k_chunk < 1 || splits != max(1, (k + k_chunk - 1) / k_chunk) ||
      (splits > 1 && ws == nullptr) || (variant == kVector && !aligned))
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

}  // namespace

// device: the CUDA device the operands and the stream belong to.
// dtype: 0 = float32, 1 = bfloat16.  x (m, k) and w (k, n) are row-major
// and contiguous; y (m, width) is written row-major.  ws: an fp32
// workspace of splits * m * width values (unused with one split).  The
// launch plan (variant 0 = 16-byte loads, 1 = scalar loads, 2 = tiled for
// m > 8; mt, the rows of X a block holds; col_tiles; splits; k_chunk, the
// rows of K per split) comes from the host planner.  Returns the CUDA
// error code of the launches (0 = launched).
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

extern "C" int split_matmul_launch(int device, int dtype, const void* x,
                                   const void* w, void* y, void* ws, int m,
                                   int k, int n, int c0, int width,
                                   int variant, int mt, int col_tiles,
                                   int splits, int k_chunk, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(device, x, w, y, ws, m, k, n, c0, width, variant,
                         mt, col_tiles, splits, k_chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, x, w, y, ws, m, k, n, c0, width,
                                 variant, mt, col_tiles, splits, k_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
