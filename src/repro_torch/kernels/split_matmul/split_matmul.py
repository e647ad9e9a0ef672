"""Hand-written CUDA kernel: channel-partitioned matmul (the co-execution
primitive).

Computes Y = X @ W[:, c0 : c0 + width] — one compute group's share of a
channel-split linear layer (paper Section 2, Fig. 4).  It replaces the TPU
kernel `src/repro/kernels/split_matmul/split_matmul.py:split_matmul`.

Bound on an H100: at batch 1 the product is a matrix-vector product that
streams W once, so it is bound by the bytes of W (VGG16's first FC layer
reads 411 MB).  Design (`csrc/split_matmul.cu`): the W pointer is offset
by c0 and read with row stride N, so no slice is copied, and ragged edges
are masked rather than padded; a skinny 8 x 32 tile serves M <= 8.

`split_matmul` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes `split_matmul_plain`, the same
function in plain PyTorch.  `split_matmul.launches` counts launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.split_matmul.ref import split_matmul_ref

#: the plain PyTorch version of the kernel's function
split_matmul_plain = split_matmul_ref


@functools.lru_cache(maxsize=None)
def _launcher():
    return build.entry_point("split_matmul", "split_matmul_launch",
                             n_ptr=3, n_int=5)


def split_matmul(x: torch.Tensor, w: torch.Tensor, c0: int,
                 width: int) -> torch.Tensor:
    """Y = X @ W[:, c0:c0+width]; x (M, K), w (K, N) -> (M, width) in x's
    dtype, accumulated in float32."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"split_matmul needs x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if not (0 <= c0 and width > 0 and c0 + width <= n):
        raise ValueError(f"split_matmul slice [{c0}, {c0 + width}) is not "
                         f"inside the {n} columns of w")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return split_matmul_plain(x, w, c0, width)
    code = build.dtype_code("split_matmul", x, w)
    y = torch.empty((m, width), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.device.index, code, x.data_ptr(), w.data_ptr(),
                      y.data_ptr(), m, k, n, c0, width, stream)
    if err:
        raise RuntimeError(f"split_matmul launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"c0 {c0}, width {width})")
    split_matmul.launches += 1
    return y


split_matmul.launches = 0
