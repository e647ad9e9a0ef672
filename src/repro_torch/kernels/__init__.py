"""Hand-written CUDA kernels for the perf-critical compute paths.

  split_matmul/      channel-partitioned matmul (co-execution primitive)
  winograd_conv/     F(2x2,3x3) convolution around the hadamard_matmul kernel
  decode_attention/  single-token GQA attention over a KV cache
  ssd_chunk/         chunked Mamba2 SSD scan
  prefill_attention/ causal prefill attention in bf16 (no registry op)

Each package has <name>.py (the kernel's wrapper and its plain PyTorch
version), ops.py (public wrapper + registry lowering) and ref.py (the
plain oracle).  Kernel sources live in `repro_torch/csrc`; build.py
compiles them with nvcc at first use and binds them with ctypes.

registry.py is the dispatch table (op kind -> JSON codec, shapes, weight
init, kernel path and oracle, typed partition axes and split lowerings)
the plan executor uses.
"""
