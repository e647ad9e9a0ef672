"""Plain PyTorch oracle for the split_matmul kernel."""
from __future__ import annotations

import torch


def split_matmul_ref(x: torch.Tensor, w: torch.Tensor, c0: int,
                     width: int) -> torch.Tensor:
    """x @ w[:, c0:c0+width], accumulated in float32 and rounded once to
    x's dtype (the kernel's arithmetic)."""
    return (x.float() @ w[:, c0:c0 + width].float()).to(x.dtype)
