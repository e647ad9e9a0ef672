// hadamard_matmul: M[g] = U[g] @ V[g] for the 16 points g of the Winograd
// F(2x2, 3x3) Hadamard domain.
//
// Replaces the TPU kernel src/repro/kernels/winograd_conv/winograd_conv.py:
// hadamard_matmul (body _hadamard_matmul_kernel), which runs the 16 products
// on a (16, P/bm, N/bn, K/bk) grid with (128, 128, 256) VMEM blocks and an
// fp32 accumulator.
//
// What bounds it on an H100: U is (16, P, K), V is (16, K, N) and M is
// (16, P, N), with P = B * ceil(H/2) * ceil(W/2) tiles.  At VGG16's
// Winograd layers K and N are 64..256, so each U and M element is touched
// K or N times: the work is bound by fp32 operations (2 * 16 * P * K * N)
// outside the tensor cores, or at the smallest K by the bytes of U and M.
//
// What the design does about it: the Winograd point is blockIdx.z, so the
// 16 products are one launch with independent blocks.  Each block computes
// a 64 x 64 tile of M[g] with a 4 x 4 register micro-tile per thread,
// staging 16-deep K slices of U and V in shared memory, so every staged
// value feeds 4 fused multiply-adds from registers.  Ragged P/N/K edges are
// masked.  Tensor-core paths (wgmma, TF32 or bf16) are later work.
#include "tiled_gemm.cuh"

namespace {

template <typename T>
int launch(const void* u, const void* v, void* out, int g, int p, int k,
           int n, cudaStream_t stream) {
  return repro_torch::launch_tiled_gemm<T, 64, 64, 16, 4, 4>(
      u, v, out, g, p, n, k, k, n, n, (long long)p * k, (long long)k * n,
      (long long)p * n, stream);
}

}  // namespace

// device: the CUDA device the operands and the stream belong to.
// dtype: 0 = float32, 1 = bfloat16.  u (g, p, k), v (g, k, n) and
// out (g, p, n) are contiguous.  Returns the CUDA error code of the launch.
extern "C" int hadamard_matmul_launch(int device, int dtype, const void* u,
                                      const void* v, void* out, int g, int p,
                                      int k, int n, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, v, out, g, p, k, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(u, v, out, g, p, k, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
