// Causal self-attention forward of a prefill from an empty cache, in bf16
// on the tensor cores (kernels/prefill_attention).
//
// It replaces no TPU kernel: the JAX package attends at prefill in plain
// code (`repro.models.flash.flash_full` above its sequence threshold,
// `attention_scores` below it), and the port's plain twin of that path
// upcast Q, K and V to fp32 and multiplied on the CUDA cores.  This kernel
// stands in for that path in the published Zamba2's shared blocks.
//
// Bound on an H100: operations.  A sequence of T tokens and one head does
// 2 hd T (T + 1) of score and value products under the causal mask and
// reads q, k, v and writes o once (8 hd T bytes), so at T = 1024 the work
// is ~250 operations a byte, at the tensor cores' bf16 rate about as long
// as the bytes take, and at T = 4096 four times the bytes' time.
//
// Design (FlashAttention-2's, on mma.sync m16n8k16):
// - one block per (batch x head, 128-query block), the last (longest)
//   query blocks launched first so that the causal triangle's long blocks
//   do not trail the grid; 8 warps, each owning 16 query rows;
// - Q resident in shared memory for the block's life; 64-key tiles of K
//   and V in a 2-stage ring filled by 16-byte cp.async copies one tile
//   ahead of the products; rows padded by 16 bytes so that ldmatrix's
//   eight row addresses fall in distinct banks;
// - S = Q K^T and O += P V on mma.sync in bf16 with fp32 accumulators; O
//   (16 x hd a warp) stays in registers through the whole key walk; the
//   running max, sum and rescale are fp32 (exp2 of log2-scaled scores),
//   and P is rounded to bf16 only as the operand of the value product, its
//   accumulator fragments reused as the A fragments without a trip
//   through shared memory;
// - causality: key tiles past the block's last query are never loaded, a
//   warp skips a tile that lies wholly past its own rows, and the mask is
//   applied only to tiles that cross a warp's diagonal or the ragged end
//   of the sequence (keys past T are zero-filled and masked);
// - the epilogue divides by the row sums, writes each warp's rows into its
//   own (now unused) rows of the Q tile and stores them with 16-byte
//   writes.
// Head widths are padded up to one of the instantiated widths (64, 128,
// 224, 256) with zero columns, which add nothing to the scores.
//
// What holds this design back: mma.sync takes no operand that warps
// share, so each warp reads the whole K and V tile from shared memory for
// its own 16 rows, ~64 KB of ldmatrix traffic a warp and tile against 224
// products; at an SM's 128 bytes a cycle that is about as long as the
// products take, and the kernel runs at ~25 % of the bf16 peak at 4 x 4096
// tokens and 224-wide heads.  Hopper's wgmma reads its B operand once for
// a warpgroup's 64 rows; to pay, it wants swizzled tiles and the softmax
// overlapped with the products (see PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "kernel_attrs.cuh"
#include "tensor_core.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // query rows a block
constexpr int kBN = 64;                  // keys a tile
constexpr int kWarps = kBM / 16;         // one warp a 16-row slice
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;               // K and V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int P = HD + 8;       // shared row pitch in elements
  static constexpr int kChunks = HD / 8; // 16-byte chunks a row
  static constexpr int kQ = kBM * P;
  static constexpr int kKV = kBN * P;
  static constexpr int kSmem =
      static_cast<int>(sizeof(bf16)) * (kQ + 2 * kStages * kKV);
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long q_sb, q_st, q_sh;            // strides in elements
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int b, t, h, kv, hd, q_blocks;
  float scale_log2;                      // scale x log2(e)
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + rows) of one head's (T, hd) operand into a shared tile
// of pitch P: rows past T and columns past hd are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long st, int row0, int rows,
                                          int t, int hd) {
  using S = Tiles<HD>;
  for (int c = threadIdx.x; c < rows * S::kChunks; c += kThreads) {
    const int r = c / S::kChunks, col = (c % S::kChunks) * 8;
    const bool ok = row0 + r < t && col < hd;
    cp_async16(dst + r * S::P + col, ok ? src + (row0 + r) * st + col : src,
               ok);
  }
}

// ---- one warp's share of a key tile: its 16 query rows x 64 keys

// S = Q K^T for the warp's rows, eight n-tiles of 8 keys
template <int HD>
__device__ __forceinline__ void score_tile(float (&s)[8][4], const bf16* qw,
                                           const bf16* kt, int lane) {
  constexpr int P = Tiles<HD>::P;
  const int r8 = lane % 8, mat = lane / 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t qa[4];
    ldsm_x4(qa, qw + (lane % 16) * P + kk + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t kb[4];
      ldsm_x4(kb, kt + (n * 8 + (mat / 2) * 8 + r8) * P + kk + (mat % 2) * 8);
      mma16816(s[n], qa, kb[0], kb[1]);
      mma16816(s[n + 1], qa, kb[2], kb[3]);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {     // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The running state of the lane's two rows (row0 = its fragment row g,
// row1 = g + 8): maxima of the raw scores, sums of 2^(scale_log2 (s - m))
struct Rows {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
};

// The tile's online-softmax step: mask keys past a row or past T (where
// `edge`), raise the row maxima, rescale O and the sums, and round the
// tile's probabilities to bf16 as the value product's A fragments
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], Rows& r,
                                             float (&o)[NT][4],
                                             uint32_t (&pa)[4][4], int k0,
                                             int row0, int t, bool edge,
                                             float scale_log2, int lane) {
  const int tq = lane % 4;
  if (edge) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tq + (e & 1);
        if (key > row0 + (e < 2 ? 0 : 8) || key >= t) s[n][e] = -INFINITY;
      }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // every row keeps key 0 of tile 0, so the maxima are finite here
  const float al0 = ex2((r.m0 - mx0) * scale_log2);
  const float al1 = ex2((r.m1 - mx1) * scale_log2);
  const float sub0 = mx0 * scale_log2, sub1 = mx1 * scale_log2;
  r.m0 = mx0;
  r.m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p0 = ex2(fmaf(s[n][0], scale_log2, -sub0));
    const float p1 = ex2(fmaf(s[n][1], scale_log2, -sub0));
    const float p2 = ex2(fmaf(s[n][2], scale_log2, -sub1));
    const float p3 = ex2(fmaf(s[n][3], scale_log2, -sub1));
    sum0 += p0 + p1;
    sum1 += p2 + p3;
    pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
    pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  r.l0 = r.l0 * al0 + sum0;
  r.l1 = r.l1 * al1 + sum1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o[n][0] *= al0;
    o[n][1] *= al0;
    o[n][2] *= al1;
    o[n][3] *= al1;
  }
}

// O += P V: V's rows are k-major, so its B fragments come transposed
template <int HD>
__device__ __forceinline__ void value_tile(float (&o)[HD / 8][4],
                                           const uint32_t (&pa)[4][4],
                                           const bf16* vt, int lane) {
  constexpr int P = Tiles<HD>::P;
  const int r8 = lane % 8, mat = lane / 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t vb[4];
      ldsm_x4_trans(
          vb, vt + (kk * 16 + (mat % 2) * 8 + r8) * P + (n + mat / 2) * 8);
      mma16816(o[n], pa[kk], vb[0], vb[1]);
      mma16816(o[n + 1], pa[kk], vb[2], vb[3]);
    }
  }
}

// O / l through the warp's own (now unused) rows of the Q tile, then out in
// 16-byte stores of the rows below T
template <int HD>
__device__ __forceinline__ void store_rows(float (&o)[HD / 8][4], Rows& r,
                                           bf16* ow, bf16* og, long long st,
                                           int row_lo, int t, int hd,
                                           int lane) {
  using S = Tiles<HD>;
  constexpr int P = S::P;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
    r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
  }
  const float inv0 = 1.f / r.l0, inv1 = 1.f / r.l1;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(ow + g * P + n * 8 + 2 * tq) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * P + n * 8 + 2 * tq) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * S::kChunks; c += 32) {
    const int rr = c / S::kChunks, col = (c % S::kChunks) * 8;
    if (row_lo + rr < t && col < hd)
      *reinterpret_cast<uint4*>(og + (row_lo + rr) * st + col) =
          *reinterpret_cast<const uint4*>(ow + rr * P + col);
  }
}

// 128 queries (8 warps) a block, one block an SM; K and V tiles in a
// 2-stage ring, the next tile's copies in flight during this tile's work
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_fwd(const Args a) {
  using S = Tiles<HD>;
  constexpr int P = S::P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);      // [kBM][P]
  bf16* ks = qs + S::kQ;                         // [kStages][kBN][P]
  bf16* vs = ks + kStages * S::kKV;              // [kStages][kBN][P]
  // the block's (batch, head, first query): the last (longest) query
  // blocks first
  const int heads = a.b * a.h, bh = blockIdx.x % heads;
  const int bi = bh / a.h, hi = bh % a.h, kvh = hi / (a.h / a.kv);
  const int q0 =
      (a.q_blocks - 1 - static_cast<int>(blockIdx.x) / heads) * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qg = a.q + bi * a.q_sb + hi * a.q_sh;
  const bf16* kg = a.k + bi * a.k_sb + kvh * a.k_sh;
  const bf16* vg = a.v + bi * a.v_sb + kvh * a.v_sh;
  const int tiles = (min(q0 + kBM, a.t) + kBN - 1) / kBN;

  load_rows<HD>(qs, qg, a.q_st, q0, kBM, a.t, a.hd);
  load_rows<HD>(ks, kg, a.k_st, 0, kBN, a.t, a.hd);
  load_rows<HD>(vs, vg, a.v_st, 0, kBN, a.t, a.hd);
  cp_async_commit();

  const int row_lo = q0 + warp * 16;             // the warp's first row
  const bf16* qw = qs + warp * 16 * P;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  Rows rows;

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      const int st = (j + 1) % kStages;
      load_rows<HD>(ks + st * S::kKV, kg, a.k_st, (j + 1) * kBN, kBN, a.t,
                    a.hd);
      load_rows<HD>(vs + st * S::kKV, vg, a.v_st, (j + 1) * kBN, kBN, a.t,
                    a.hd);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // tile j (and Q) landed
    __syncthreads();
    const int k0 = j * kBN;
    if (k0 <= row_lo + 15) {                     // some key of the tile counts
      float s[8][4];
      uint32_t pa[4][4];
      score_tile<HD>(s, qw, ks + (j % kStages) * S::kKV, lane);
      softmax_tile(s, rows, o, pa, k0, row_lo + lane / 4, a.t,
                   k0 + kBN - 1 > row_lo || k0 + kBN > a.t, a.scale_log2,
                   lane);
      value_tile<HD>(o, pa, vs + (j % kStages) * S::kKV, lane);
    }
    __syncthreads();                             // stage j % 2 is free
  }
  cp_async_wait<0>();
  store_rows<HD>(o, rows, qs + warp * 16 * P,
                 a.o + bi * a.o_sb + hi * a.o_sh, a.o_st, row_lo, a.t, a.hd,
                 lane);
}

template <int HD>
int launch_width(int device, const Args& a, cudaStream_t stream) {
  const int set = configure_smem_once<prefill_attention_fwd<HD>>(device);
  if (set != 0) return set;
  prefill_attention_fwd<HD>
      <<<a.q_blocks * a.b * a.h, kThreads, Tiles<HD>::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// device: the CUDA device of the operands and the stream.  dtype: 1 =
// bfloat16, the only one taken.  q (B, T, H, hd), k and v (B, T, KV, hd)
// and o (B, T, H, hd), each by its (batch, token, head) strides in
// elements, the last dimension dense; every row 16-byte aligned.  width:
// the instantiated head width hd is padded to (64, 128, 224 or 256).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int prefill_attention_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    void* o, int b, int t, int h, int kv, int hd, int width, int q_sb,
    int q_st, int q_sh, int k_sb, int k_st, int k_sh, int v_sb, int v_st,
    int v_sh, int o_sb, int o_st, int o_sh, float scale, void* stream) {
  using namespace repro_torch;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (dtype != 1 || b < 1 || t < 1 || kv < 1 || h % kv || hd > width ||
      hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<bf16*>(o),
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
         o_sb, o_st, o_sh, b, t, h, kv, hd, (t + kBM - 1) / kBM,
         scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64: return launch_width<64>(device, a, s);
    case 128: return launch_width<128>(device, a, s);
    case 224: return launch_width<224>(device, a, s);
    case 256: return launch_width<256>(device, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
