// ssd_chunk_scan: the Mamba2 SSD scan.  For every (batch, head) the (hd, N)
// state h is carried through T tokens,
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,
// and the kernels return the final state and y.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk/ssd_chunk.py:
// ssd_chunk_scan (body _ssd_chunk_kernel): a (B, H, T/L) grid with the chunk
// axis innermost and sequential, the state carried across chunk steps in
// VMEM scratch, L = 256 by default.
//
// Two designs, chosen on the host per call (repro_torch/kernels/ssd_chunk/
// ssd_chunk.py: plan_ssd).
//
// `ssd_decode`, for T <= DECODE_T_MAX (decode).  At T = 1 (zamba2-7b: H =
// 112, hd = N = 64) the scan reads state0 and writes the final state once,
// 1.8 MB each in fp32, for ~0.3 Mflop: bound by bytes, about 1.1 us at
// 3.35 TB/s, far below the few microseconds any launch takes from start to
// drain.  It runs the recurrence itself, which is exact and has no chunk
// machinery to pay for.  A block of 128 threads owns `rows` rows of one
// head's state; the `lanes` lanes of one row hold 8 state values each in
// registers (N = 64: 8 lanes, 16 rows per block, four blocks per head, 448
// blocks for the zamba2-7b step).  Each thread issues its 16-byte state
// loads first (streaming: the state is read once) and the load of a; the
// block stages its dt, B, C and x for the T tokens (a few hundred bytes at
// T = 1) in shared memory; then each thread steps the tokens in registers,
// h <- exp(dt a) h + (dt x_d) B_k, with y_d = sum_k C_k h_dk by a shuffle
// sum across the row's lanes.  It writes the final state once.  The state
// never touches shared memory, and the only barrier is the one after the
// operands are staged.  Where state0, the final state or the row pitch
// N * sizeof(T) is not 16-byte aligned, the same kernel loads and stores the
// state one element at a time.
//
// The chunk kernels, for longer T (prefill).  Per token and head the scan
// takes 3 hd N multiply-adds (the count its bound uses) and reads x and
// writes y once: at zamba2-7b's widths ~24 flops a byte in fp32, over the
// card's 20 (67 TFLOP/s of fp32 FMA over 3.35 TB/s), so outside the tensor
// cores fp32 operations bound it, on them bytes.  The design before this
// one (one block per (batch, head) walking its chunks in order, every FMA
// reading its operands from shared memory) ran at ~7 % of that bound:
// shared-memory bandwidth (two loads a FMA), B H blocks at two a SM, one
// thread taking the cumulative sum.  This one is the SSD algorithm of the
// Mamba2 paper (arXiv:2405.21060 sec. 6) in three launches, every chunk in
// parallel but for the second launch's walk; l is the chunk's cumulative
// sum of dt a:
//
// 1. `ssd_chunk_state`, grid (chunk, head group, batch): each head's own
//    end state of the chunk, S_c = sum_j (dt_j exp(l_L - l_j) x_j) B_j^T
//    (hd x N, depth L), and its decay exp(l_L), into the workspace.  The
//    chunk's B is staged once per block, transposed and split into its
//    TF32 parts once for all the group's heads; each head's x tile is
//    staged with cp.async while the previous one is multiplied (two
//    buffers, B staged in the second until it is split, so three blocks fit
//    an SM); l is a warp-shuffle scan, one warp a head.
// 2. `ssd_chunk_pass`, one thread per 4 state elements of a (batch, head):
//    walks the chunks in order, h_in[c] = h, then h = exp(l_L) h + S_c,
//    writing h_in[c] over S_c, and writes the final state.  No atomics:
//    every sum has one order, so two calls are bit-identical.
// 3. `ssd_chunk_out`, grid (chunk, head group, batch):
//      y_t = exp(l_t) (C_t h_in[c]^T) + sum_{j <= t} W_tj dt_j x_j,
//      W_tj = (C_t . B_j) exp(l_t - l_j).
//    B and C are per token (zamba2 has one group), so C B^T (L x L) is
//    taken once per block and shared by its heads; exp(l_t) scales the
//    accumulator's rows.  W is formed as the product's operand is loaded,
//    with a select on j <= t and never a multiply by a mask: l decreases,
//    so exp(l_t - l_j) for j > t can overflow to inf, and inf x 0 is NaN.
//
// Every product runs on the tensor cores at fp32 accuracy: mma.sync
// m16n8k8 in TF32 with the 3xTF32 split.  Each fp32 operand v is split
// into big = tf32(v) and small = tf32(v - big), and acc += small big + big
// small + big big in fp32 accumulators; one TF32 product alone keeps ~11
// bits, over the 5e-5 the card's parity check holds fp32 to.  On the H100
// the tensor cores are not what these kernels wait on: built with the MMAs
// compiled out, the out kernel ran nearly as long.  The operands' loads
// and splits are, so the design spends its effort there:
// - tf32() truncates (clears the 13 low mantissa bits, one logic op) where
//   cvt.rna takes several, and the split still keeps v to 2^-20;
// - each lane's two k slots t and t + 4 of a step are given neighbouring
//   columns, so one 64-bit (fp32) or 32-bit (bf16) load reads both, and
//   tile rows are padded so a warp's loads hit distinct banks;
// - the three MMAs of a split run in passes over the warp's four column
//   tiles, so neighbouring MMAs write different accumulators.
//
// The workspace, allocated by the wrapper (the kernels allocate nothing),
// holds the (B, H, nc, hd, N) fp32 chunk states, then the (B, H, nc)
// decays.  It is written, read, rewritten and read again, the design's
// largest byte term: at L = 64 and hd = N = 64 it is as large as x in fp32
// (59 MB at B = 4, T = 512).  L = 128 would halve it, but doubles the out
// kernel's (L, L) products and its 64 KB tile leaves one block a SM; the
// host's default is L = 64 (CHUNK), the faster of the two on the card
// (chip_smoke.py's tune phase times every chunk).
//
// Any hd (tiles of 64 rows of the state), any N a block's shared memory
// holds, and a ragged last chunk: staged tiles are zero-filled (cp.async
// with a source size of 0) past hd, N and the chunk, and stores are
// masked.  Inputs are f32 or bf16; all arithmetic is fp32.
#include <cstdint>
#include <math.h>

#include "kernel_attrs.cuh"
#include "tensor_core.cuh"
#include "tiled_gemm.cuh"

namespace {

using repro_torch::configure_smem_once;
using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::FragA;
using repro_torch::FragB;
using repro_torch::from_f32;
using repro_torch::ld2;
using repro_torch::mma3;
using repro_torch::store_pair;
using repro_torch::to_f32;

constexpr int kDecodeThreads = 128;    // decode kernel
constexpr int kLaneElems = 8;          // state values a decode lane holds

constexpr int kThreads = 256;          // chunk-state and chunk-out blocks
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;      // chunk-pass blocks
constexpr int kPassElems = 4;          // state elements a pass thread walks
constexpr int kPassAhead = 4;          // chunk states it loads before using
constexpr int kTileD = 64;             // state rows (columns of y) a tile
constexpr int kMaxChunk = 128;         // tokens a chunk: 8 row tiles of 16
constexpr int kMaxHeads = 4;           // heads a state or out block
// Row padding, in elements, of a tile whose fragments read rows by the
// lane's groupID and each lane two neighbouring columns at once (one 64-bit
// load in fp32, one 32-bit load in bf16): 8, so the rows of a half warp
// start 8 banks (fp32) or 4 words (bf16) apart
constexpr int kPad = 8;

// variants, as the host plan names them
// variants, as the host plan names them
constexpr int kDecodeVector = 0, kDecodeScalar = 1, kChunk = 2;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row padding, in elements, of an x tile, whose fragments read rows 2t and
// 2t + 1 (t: threadID_in_group) and columns by groupID: 4 in fp32, so the
// four even rows start 8 banks apart; 8 in bf16 (8 words)
template <typename T>
__host__ __device__ constexpr int pad_x() {
  return sizeof(T) == 4 ? 4 : 8;
}

// Dynamic shared memory, in bytes, of a chunk-state block: B^T split into
// its TF32 parts (two (np, lp + kPad) words), two x tiles (lp, kTileD +
// pad_x), the second at least B's size as staged (lp, np + kPad): B is
// staged there until it is split; and two (G, lp) fp32 vectors.
template <typename T>
__host__ __device__ int state_smem(int L, int N, int G) {
  const int lp = round_up(L, 16), np = round_up(N, 8);
  const int xt = lp * (kTileD + pad_x<T>()), bt = lp * (np + kPad);
  return 4 * 2 * np * (lp + kPad) +
         static_cast<int>(sizeof(T)) * (xt + (xt > bt ? xt : bt)) +
         4 * 2 * G * lp;
}

// One item buffer of a chunk-out block: an x tile and an h_in tile (fp32,
// kTileD rows of N).
template <typename T>
__host__ __device__ int out_buffer(int L, int N) {
  const int lp = round_up(L, 16), np = round_up(N, 8);
  return static_cast<int>(sizeof(T)) * lp * (kTileD + pad_x<T>()) +
         4 * kTileD * (np + kPad);
}

// Dynamic shared memory of a chunk-out block: C (lp, np + kPad), C B^T
// (lp, lp + kPad) fp32, two item buffers (the second at least B's size: B
// is staged there until C B^T is taken) and three (G, lp) fp32 vectors.
template <typename T>
__host__ __device__ int out_smem(int L, int N, int G) {
  const int lp = round_up(L, 16), np = round_up(N, 8);
  const int tile = static_cast<int>(sizeof(T)) * lp * (np + kPad);
  const int buf = out_buffer<T>(L, N);
  return tile + 4 * lp * (lp + kPad) + buf + (buf > tile ? buf : tile) +
         4 * 3 * G * lp;
}

// Stage a row-major global tile (row stride ld elements) into shared memory
// (row pitch sp) as rows x cols, zero past nrows and ncols.  VEC: 16-byte
// cp.async copies (ncols, ld, cols and the tile's address whole 16-byte
// chunks); otherwise synchronous loads.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* s, int sp, const T* __restrict__ g,
                                      long long ld, int nrows, int ncols,
                                      int rows, int cols) {
  if constexpr (VEC) {
    constexpr int CE = 16 / static_cast<int>(sizeof(T));
    const int per_row = cols / CE;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, k = (e % per_row) * CE;
      const bool ok = r < nrows && k < ncols;
      cp_async16(s + r * sp + k, ok ? g + r * ld + k : g, ok);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, k = e % cols;
      s[r * sp + k] = (r < nrows && k < ncols) ? g[r * ld + k] : zero;
    }
  }
}

// l_j = sum_{i <= j} dt_i a for the chunk's lp rows (dt is 0 past the
// chunk), by one warp: each lane sums a run of lp / 32 consecutive terms
// (at most 4), and the runs' totals are scanned with shuffles.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* ls, int lp, int lane) {
  const int per = (lp + 31) / 32;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = lane * per + i;
    v[i] = (i < per && j < lp) ? dts[j] * a : 0.f;
    run += v[i];
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = lane * per + i;
    acc += v[i];
    if (i < per && j < lp) ls[j] = acc;
  }
}

// dt of the chunk's rows for heads h0 .. h0 + heads - 1, as (heads, lp)
// fp32, zero past the chunk's n tokens
template <typename T>
__device__ __forceinline__ void load_dt(float* dts, const T* __restrict__ dt,
                                        long long row0, int n, int lp, int H,
                                        int h0, int heads) {
  for (int e = threadIdx.x; e < heads * lp; e += blockDim.x) {
    const int g = e / lp, j = e % lp;
    dts[e] = j < n ? to_f32(dt[(row0 + j) * H + h0 + g]) : 0.f;
  }
}

// Grid (nc, ceil(H / G), B), kThreads: chunk c of batch bi, heads h0 ..
// h0 + G - 1.  x (B, T, H, hd); b (B, T, N); dt (B, T, H); a (H).  Writes
// each head's chunk state S_c (hd, N) to ws[(bi H + h) nc + c] and its
// decay exp(l_L) to decay[(bi H + h) nc + c].
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_state(const T* __restrict__ x, const T* __restrict__ b,
                const T* __restrict__ dt, const T* __restrict__ a,
                float* __restrict__ ws, float* __restrict__ decay, int Tn,
                int H, int hd, int N, int L, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = round_up(L, 16), np = round_up(N, 8);
  const int bp = np + kPad, tp = lp + kPad;          // row pitches
  const int xp = kTileD + pad_x<T>();
  uint32_t* tb = reinterpret_cast<uint32_t*>(smem);  // (np, tp): B^T's
  uint32_t* tsm = tb + np * tp;                      // big and small parts
  T* xs = reinterpret_cast<T*>(tsm + np * tp);       // x tiles (lp, xp)
  T* xs1 = xs + lp * xp;                             // and the second
  T* bs = xs1;                          // (lp, bp): B as staged, until split
  float* wv = reinterpret_cast<float*>(
      xs1 + (lp * xp > lp * bp ? lp * xp : lp * bp));   // (G, lp)
  float* lv = wv + G * lp;                               // (G, lp): l
  const int c = blockIdx.x, nc = gridDim.x, h0 = blockIdx.y * G;
  const int bi = blockIdx.z;
  const int t0 = c * L, n = min(L, Tn - t0), heads = min(G, H - h0);
  const int tiles = (hd + kTileD - 1) / kTileD, items = heads * tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long long row0 = (long long)bi * Tn + t0;   // the chunk's first token

  // item it: head h0 + it / tiles, state rows from (it % tiles) * kTileD
  auto stage_x = [&](int it, T* dst) {
    const int g = it / tiles, d0 = (it % tiles) * kTileD;
    stage<T, VEC>(dst, xp, x + (row0 * H + h0 + g) * hd + d0,
                  (long long)H * hd, n, min(kTileD, hd - d0), lp, kTileD);
  };
  stage<T, VEC>(bs, bp, b + row0 * N, N, n, N, lp, np);
  stage_x(0, xs);
  cp_async_commit();
  load_dt(wv, dt, row0, n, lp, H, h0, heads);
  __syncthreads();
  if (warp < heads) {   // wv <- dt_j exp(l_L - l_j), one warp a head
    float* w = wv + warp * lp;
    float* l = lv + warp * lp;
    chunk_cumsum(w, to_f32(a[h0 + warp]), l, lp, lane);
    __syncwarp();
    const float lend = l[n - 1];
    for (int j = lane; j < lp; j += 32) w[j] *= expf(lend - l[j]);
    if (lane == 0)
      decay[((long long)bi * H + h0 + warp) * nc + c] = expf(lend);
  }
  cp_async_wait<0>();
  __syncthreads();
  // B^T split once, for every head of the block
  for (int e = threadIdx.x; e < lp * np; e += kThreads) {
    const int j = e / np, k = e % np;
    FragB f;
    f.set(0, to_f32(bs[j * bp + k]));
    tb[k * tp + j] = f.big[0];
    tsm[k * tp + j] = f.small[0];
  }
  __syncthreads();     // B's buffer takes the second x tile from here

  const int kend = round_up(n, 8);          // depth: the chunk's tokens
  const int ncb = (np + 31) / 32;           // column blocks of 32 of N
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) stage_x(it + 1, (it + 1) & 1 ? xs1 : xs);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int g = it / tiles, d0 = (it % tiles) * kTileD;
    const T* xt = it & 1 ? xs1 : xs;
    const float* w = wv + g * lp;
    float* out = ws + (((long long)bi * H + h0 + g) * nc + c) * hd * N;
    // warp item: state rows d0 + m0 .. + 15, columns n0 .. n0 + 31
    for (int wi = warp; wi < 4 * ncb; wi += kWarps) {
      const int m0 = (wi % 4) * 16, n0 = (wi / 4) * 32;
      if (d0 + m0 >= hd) continue;
      const int live = min(4, (np - n0) / 8);   // column tiles inside N
      float acc[4][4] = {};
      for (int j0 = 0; j0 < kend; j0 += 8) {
        const int jp = j0 + 2 * tig;       // tokens of k slots t, t + 4
        const float2 w2 = ld2(w + jp);
        const T* x0 = xt + jp * xp + m0 + gid;
        FragA fa;
        fa.set(0, to_f32(x0[0]) * w2.x);
        fa.set(1, to_f32(x0[8]) * w2.x);
        fa.set(2, to_f32(x0[xp]) * w2.y);
        fa.set(3, to_f32(x0[xp + 8]) * w2.y);
        FragB fb[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < live) {
            const int o = (n0 + nt * 8 + gid) * tp + jp;
            const uint2 big = *reinterpret_cast<const uint2*>(tb + o);
            const uint2 small = *reinterpret_cast<const uint2*>(tsm + o);
            fb[nt].big[0] = big.x;
            fb[nt].big[1] = big.y;
            fb[nt].small[0] = small.x;
            fb[nt].small[1] = small.y;
          }
        }
        mma3(acc, fa, fb, live);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int k = n0 + nt * 8 + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = d0 + m0 + gid + 8 * half;
          if (d < hd)
            store_pair(out + (long long)d * N, k, N, acc[nt][2 * half],
                       acc[nt][2 * half + 1]);
        }
      }
    }
    __syncthreads();   // the buffer is staged again two items on
  }
}

// Grid ceil(B H hd N / (V kPassThreads)).  Each thread walks V neighbouring
// elements of one (batch, head)'s state through the chunks in order: h_in[c]
// = h written over S_c, then h = decay_c h + S_c; state0 in, the final
// state out.  ws as ssd_chunk_state left it.
template <typename T, int V>
__global__ void __launch_bounds__(kPassThreads)
ssd_chunk_pass(const T* __restrict__ state0, T* __restrict__ sf, float* ws,
               const float* __restrict__ decay, long long total, int hdn,
               int nc) {
  const long long e =
      ((long long)blockIdx.x * kPassThreads + threadIdx.x) * V;
  if (e >= total) return;
  const long long bh = e / hdn;
  float* s = ws + bh * nc * hdn + e % hdn;
  const float* dc = decay + bh * nc;
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = to_f32(state0[e + v]);
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    float sv[kPassAhead][V], dv[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u >= nc) break;
      const float* p = s + (long long)(c0 + u) * hdn;
      if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        sv[u][0] = q.x;
        sv[u][1] = q.y;
        sv[u][2] = q.z;
        sv[u][3] = q.w;
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) sv[u][v] = p[v];
      }
      dv[u] = dc[c0 + u];
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u >= nc) break;
      float* p = s + (long long)(c0 + u) * hdn;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(h[0], h[1], h[2], h[3]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) p[v] = h[v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        h[v] = __fadd_rn(__fmul_rn(dv[u], h[v]), sv[u][v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) sf[e + v] = from_f32<T>(h[v]);
}

// Grid (nc, ceil(H / G), B), kThreads: chunk c of batch bi, heads h0 ..
// h0 + G - 1.  Operands as for ssd_chunk_state, plus cm (C, (B, T, N)) and
// ws as ssd_chunk_pass left it (h_in); writes y (B, T, H, hd).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_out(const T* __restrict__ x, const T* __restrict__ b,
              const T* __restrict__ cm, const T* __restrict__ dt,
              const T* __restrict__ a, const float* __restrict__ ws,
              T* __restrict__ y, int Tn, int H, int hd, int N, int L, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = round_up(L, 16), np = round_up(N, 8);
  const int cp = np + kPad, sp = lp + kPad, hp = np + kPad;   // row pitches
  const int xp = kTileD + pad_x<T>();
  const int tile = static_cast<int>(sizeof(T)) * lp * cp;
  const int buf = out_buffer<T>(L, N);
  T* cs = reinterpret_cast<T*>(smem);                          // (lp, cp)
  float* cb = reinterpret_cast<float*>(smem + tile);           // (lp, sp)
  unsigned char* bufs = smem + tile + 4 * lp * sp;             // 2 buffers
  T* bs = reinterpret_cast<T*>(bufs + buf);    // (lp, cp): B, in buffer 1
  float* dtv = reinterpret_cast<float*>(bufs + buf + (buf > tile ? buf
                                                                 : tile));
  float* lv = dtv + G * lp;                    // (G, lp): l
  float* ev = lv + G * lp;                     // (G, lp): exp(l)
  const int c = blockIdx.x, nc = gridDim.x, h0 = blockIdx.y * G;
  const int bi = blockIdx.z;
  const int t0 = c * L, n = min(L, Tn - t0), heads = min(G, H - h0);
  const int tiles = (hd + kTileD - 1) / kTileD, items = heads * tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long long row0 = (long long)bi * Tn + t0;
  const int mtiles = lp / 16;

  // buffer k: the x tile (lp, xp), then the h_in tile (kTileD, hp) fp32
  auto xbuf = [&](int k) { return reinterpret_cast<T*>(bufs + k * buf); };
  auto hbuf = [&](int k) {
    return reinterpret_cast<float*>(bufs + k * buf +
                                    sizeof(T) * lp * xp);
  };
  auto stage_item = [&](int it, int k) {
    const int g = it / tiles, d0 = (it % tiles) * kTileD;
    const int rows = min(kTileD, hd - d0);
    stage<T, VEC>(xbuf(k), xp, x + (row0 * H + h0 + g) * hd + d0,
                  (long long)H * hd, n, rows, lp, kTileD);
    stage<float, VEC>(
        hbuf(k), hp,
        ws + (((long long)bi * H + h0 + g) * nc + c) * hd * N +
            (long long)d0 * N,
        N, rows, N, kTileD, np);
  };
  stage<T, VEC>(cs, cp, cm + row0 * N, N, n, N, lp, np);
  stage<T, VEC>(bs, cp, b + row0 * N, N, n, N, lp, np);
  stage_item(0, 0);
  cp_async_commit();
  load_dt(dtv, dt, row0, n, lp, H, h0, heads);
  __syncthreads();
  if (warp < heads) {
    chunk_cumsum(dtv + warp * lp, to_f32(a[h0 + warp]), lv + warp * lp, lp,
                 lane);
    __syncwarp();
    for (int j = lane; j < lp; j += 32)
      ev[warp * lp + j] = expf(lv[warp * lp + j]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // C B^T on and below the diagonal: warp items of 16 rows x 32 columns
  const int jcb = (lp + 31) / 32;
  for (int wi = warp; wi < mtiles * jcb; wi += kWarps) {
    const int m0 = (wi % mtiles) * 16, n0 = (wi / mtiles) * 32;
    if (n0 > m0 + 15) continue;
    // column tiles inside the chunk and at or below the diagonal
    const int live = min(4, (min(lp, m0 + 16) - n0) / 8);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < np; k0 += 8) {
      const int kp = k0 + 2 * tig;
      const float2 c0 = ld2(cs + (m0 + gid) * cp + kp);
      const float2 c1 = ld2(cs + (m0 + gid + 8) * cp + kp);
      FragA fa;
      fa.set(0, c0.x);
      fa.set(1, c1.x);
      fa.set(2, c0.y);
      fa.set(3, c1.y);
      FragB fb[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < live) {
          const float2 b2 = ld2(bs + (n0 + nt * 8 + gid) * cp + kp);
          fb[nt].set(0, b2.x);
          fb[nt].set(1, b2.y);
        }
      }
      mma3(acc, fa, fb, live);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < live) {
        float* r = cb + (m0 + gid) * sp + n0 + nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(r) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(r + 8 * sp) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
  __syncthreads();     // B's buffer is free from here

  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) stage_item(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int g = it / tiles, d0 = (it % tiles) * kTileD;
    const T* xt = xbuf(it & 1);
    const float* ht = hbuf(it & 1);
    const float* dg = dtv + g * lp;
    const float* lg = lv + g * lp;
    const float* eg = ev + g * lp;
    T* yh = y + (row0 * H + h0 + g) * hd + d0;     // token r: + r H hd
    // warp item: tokens m0 .. m0 + 15, state rows d0 + n0 .. + 31
    for (int wi = warp; wi < 2 * mtiles; wi += kWarps) {
      const int m0 = (wi % mtiles) * 16, n0 = (wi / mtiles) * 32;
      if (d0 + n0 >= hd || m0 >= n) continue;
      const int r0 = m0 + gid, r1 = r0 + 8;
      float acc[4][4] = {};
      // inter-chunk: C_t . h_in[d], then times exp(l_t)
      for (int k0 = 0; k0 < np; k0 += 8) {
        const int kp = k0 + 2 * tig;
        const float2 c0 = ld2(cs + r0 * cp + kp);
        const float2 c1 = ld2(cs + r1 * cp + kp);
        FragA fa;
        fa.set(0, c0.x);
        fa.set(1, c1.x);
        fa.set(2, c0.y);
        fa.set(3, c1.y);
        FragB fb[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 h2 = ld2(ht + (n0 + nt * 8 + gid) * hp + kp);
          fb[nt].set(0, h2.x);
          fb[nt].set(1, h2.y);
        }
        mma3(acc, fa, fb);
      }
      const float e0 = eg[r0], e1 = eg[r1];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
      // intra-chunk: W_tj dt_j x_j over j <= t
      const float l0 = lg[r0], l1 = lg[r1];
      const int jend = min(m0 + 16, round_up(n, 8));
      for (int j0 = 0; j0 < jend; j0 += 8) {
        const int jp = j0 + 2 * tig;       // tokens of k slots t, t + 4
        const float2 l2 = ld2(lg + jp);
        const float2 w0 = ld2(cb + r0 * sp + jp);
        const float2 w1 = ld2(cb + r1 * sp + jp);
        FragA fa;
        fa.set(0, jp <= r0 ? w0.x * __expf(l0 - l2.x) : 0.f);
        fa.set(1, jp <= r1 ? w1.x * __expf(l1 - l2.x) : 0.f);
        fa.set(2, jp + 1 <= r0 ? w0.y * __expf(l0 - l2.y) : 0.f);
        fa.set(3, jp + 1 <= r1 ? w1.y * __expf(l1 - l2.y) : 0.f);
        const float2 d2 = ld2(dg + jp);
        const T* x0 = xt + jp * xp + n0 + gid;
        FragB fb[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          fb[nt].set(0, to_f32(x0[nt * 8]) * d2.x);
          fb[nt].set(1, to_f32(x0[xp + nt * 8]) * d2.y);
        }
        mma3(acc, fa, fb);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int k = n0 + nt * 8 + 2 * tig;
        if (r0 < n)
          store_pair(yh + (long long)r0 * H * hd, k, hd - d0, acc[nt][0],
                     acc[nt][1]);
        if (r1 < n)
          store_pair(yh + (long long)r1 * H * hd, k, hd - d0, acc[nt][2],
                     acc[nt][3]);
      }
    }
    __syncthreads();
  }
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
// Operands as for ssd_chunk_out, plus state0; writes y and sf.
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


// The three chunk kernels, on the host plan (ssd_chunk.py: plan_ssd), checked:
// a launch that does not match it is refused.
template <typename T, bool VEC>
int launch_chunks(int device, const T* x, const T* b, const T* c,
                  const T* dt, const T* a, const T* state0, T* y, T* sf,
                  float* ws, int B, int Tn, int H, int hd, int N, int L,
                  int G, int smem_state, int smem_out, cudaStream_t stream) {
  const int nc = (Tn + L - 1) / L, groups = (H + G - 1) / G;
  const long long total = (long long)B * H * hd * N;
  const int V = (hd * N) % kPassElems == 0 ? kPassElems : 1;
  const long long pass_blocks =
      (total / V + kPassThreads - 1) / kPassThreads;
  if (B > 65535 || groups > 65535 || pass_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = configure_smem_once<ssd_chunk_state<T, VEC>>(device);
  if (err == 0) err = configure_smem_once<ssd_chunk_out<T, VEC>>(device);
  if (err != 0) return err;
  float* decay = ws + total * nc;
  const dim3 grid(nc, groups, B);
  ssd_chunk_state<T, VEC><<<grid, kThreads, smem_state, stream>>>(
      x, b, dt, a, ws, decay, Tn, H, hd, N, L, G);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (V == kPassElems)
    ssd_chunk_pass<T, kPassElems>
        <<<static_cast<unsigned>(pass_blocks), kPassThreads, 0, stream>>>(
            state0, sf, ws, decay, total, hd * N, nc);
  else
    ssd_chunk_pass<T, 1>
        <<<static_cast<unsigned>(pass_blocks), kPassThreads, 0, stream>>>(
            state0, sf, ws, decay, total, hd * N, nc);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_chunk_out<T, VEC><<<grid, kThreads, smem_out, stream>>>(
      x, b, c, dt, a, ws, y, Tn, H, hd, N, L, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int device, const void* xv, const void* bv, const void* cv,
           const void* dtv, const void* av, const void* s0v, void* yv,
           void* sfv, void* wsv, int B, int Tn, int H, int hd, int N,
           int variant, int lanes, int L, int smem, int heads,
           int smem_state, int vec, cudaStream_t stream) {
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
    auto aligned = [](const void* p) {
      return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
    };
    const bool stageable =
        aligned(x) && aligned(b) && aligned(c) &&
        (static_cast<long long>(hd) * sizeof(T)) % 16 == 0 &&
        (static_cast<long long>(N) * sizeof(T)) % 16 == 0;
    if (L < 1 || L > kMaxChunk || heads < 1 || heads > kMaxHeads ||
        wsv == nullptr || smem_state != state_smem<T>(L, N, heads) ||
        smem != out_smem<T>(L, N, heads) || (vec != 0 && vec != 1) ||
        (vec == 1 && !stageable))
      return static_cast<int>(cudaErrorInvalidValue);
    float* ws = static_cast<float*>(wsv);
    if (vec)
      return launch_chunks<T, true>(device, x, b, c, dt, a, state0, y, sf,
                                    ws, B, Tn, H, hd, N, L, heads,
                                    smem_state, smem, stream);
    return launch_chunks<T, false>(device, x, b, c, dt, a, state0, y, sf, ws,
                                   B, Tn, H, hd, N, L, heads, smem_state,
                                   smem, stream);
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
// per state row and smem = 4 T (1 + 2 N + 128 / lanes) bytes (ws, heads,
// smem_state and vec unused); variant 2 is the three chunk kernels with
// chunk length L (<= 128), `heads` (<= 4) heads a state and out block,
// smem_state and smem bytes of dynamic shared memory for the state and out
// blocks (state_smem and out_smem above, which the caller has checked fit
// a block), vec 1 to stage with 16-byte cp.async copies (x, b and c 16-byte
// aligned, hd and N whole 16-byte rows) and 0 for synchronous loads, and
// ws the fp32 workspace of B H ceil(T / L) (hd N + 1) floats.  Returns the
// CUDA error code of the first launch that failed, or 0.
extern "C" int ssd_chunk_launch(int device, int dtype, const void* x,
                                const void* b, const void* c, const void* dt,
                                const void* a, const void* state0, void* y,
                                void* sf, void* ws, int B, int Tn, int H,
                                int hd, int N, int variant, int lanes, int L,
                                int smem, int heads, int smem_state, int vec,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(device, x, b, c, dt, a, state0, y, sf, ws, B, Tn, H,
                         hd, N, variant, lanes, L, smem, heads, smem_state,
                         vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, x, b, c, dt, a, state0, y, sf, ws,
                                 B, Tn, H, hd, N, variant, lanes, L, smem,
                                 heads, smem_state, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
