"""The precision a reference or its control computes in.

`EXACT` is fp32 with TF32 off (the references).  The control of a
configuration is the nearest precision below the one it states: for fp32
with TF32 off that is TF32, each operand of every product and convolution
rounded to TF32's 10-bit mantissa and the products summed in fp32, what
one pass of the tensor cores does.  The rounding is explicit, so it does
not depend on the backend's TF32 switch.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """fp32 products and convolutions stay fp32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def keep(x: torch.Tensor) -> torch.Tensor:
    return x.float()


class Precision:
    """How a reference computes: `operand` rounds each operand of every
    product and convolution, which then sums in fp32."""

    def __init__(self, operand: Callable[[torch.Tensor], torch.Tensor]):
        self.operand = operand


#: the references' precision, and the controls' by the type a
#: configuration states
EXACT = Precision(keep)
CONTROLS = {"float32": Precision(round_tf32)}
