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
// first FC layer reads 25088 x 4096 x 4 B = 411 MB.
//
// What the design does about it: the W pointer is offset by c0 and rows are
// read with stride ldw = N, so no channel slice is ever copied; ragged edges
// are masked instead of padded.  Rows of W are read in 128-byte runs by
// neighbouring threads.  For M <= 8 a skinny tile (8 x 32 outputs, 64-deep K
// steps) gives N/32 blocks; larger M takes a 64 x 64 tile with a 4 x 4
// register micro-tile per thread.  Neither splits K across blocks, so at
// M = 1 the grid is only N/32 blocks deep: that is the first thing to change
// when this kernel is made fast.
#include "tiled_gemm.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* w, void* y, int m, int k, int n, int c0,
           int width, cudaStream_t stream) {
  const T* wc = static_cast<const T*>(w) + c0;
  if (m <= 8) {
    return repro_torch::launch_tiled_gemm<T, 8, 32, 64, 1, 1>(
        x, wc, y, 1, m, width, k, k, n, width, 0, 0, 0, stream);
  }
  return repro_torch::launch_tiled_gemm<T, 64, 64, 16, 4, 4>(
      x, wc, y, 1, m, width, k, k, n, width, 0, 0, 0, stream);
}

}  // namespace

// device: the CUDA device the operands and the stream belong to.
// dtype: 0 = float32, 1 = bfloat16.  x (m, k) and w (k, n) are row-major
// and contiguous; y (m, width) is written row-major.  Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int split_matmul_launch(int device, int dtype, const void* x,
                                   const void* w, void* y, int m, int k,
                                   int n, int c0, int width, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, m, k, n, c0, width, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, m, k, n, c0, width, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
