"""Plain PyTorch oracle: direct SAME convolution in the reference layouts.

x is NHWC and w is HWIO, as in the JAX package; the NCHW view cuDNN takes
is made here (a contiguous NHWC tensor is NCHW in channels-last memory, so
no copy).  Padding follows XLA's SAME geometry exactly — total =
max((ceil(H/S) - 1) * S + K - H, 0), the smaller half before — which
`padding="same"` cannot express for stride > 1.  The convolution runs in
float32 with TF32 off, since cuDNN would otherwise round fp32 inputs to
TF32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) SAME padding of one spatial axis, as XLA computes it."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, *,
               stride: int = 1) -> torch.Tensor:
    """x: (B,H,W,Cin); w: (K,K,Cin,Cout) -> (B,ceil(H/S),ceil(W/S),Cout),
    SAME padding."""
    ph = same_pads(x.shape[1], w.shape[0], stride)
    pw = same_pads(x.shape[2], w.shape[1], stride)
    xn = F.pad(x.float().permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    wn = w.float().permute(3, 2, 0, 1)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xn, wn, stride=stride)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
