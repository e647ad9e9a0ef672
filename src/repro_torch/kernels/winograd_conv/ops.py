"""Conv dispatch with TFLite-style kernel selection, and its registry
lowering.

`conv2d_op` mirrors the paper's kernel-selection logic (Section 3.2): 3x3
stride-1 convs with enough channels take the Winograd path; everything
else runs the direct convolution (`conv2d_ref`), as the JAX package does.
The gate is decided on the node's declared `ConvOp`, never on the width of
one group's weight slice, so a co-executed node keeps one algorithm on
both sides of its split.

This module registers the "conv" lowering in the port's kernel registry.
The op's declared output shape uses floor division (`ConvOp.H_out`) while
SAME convolution produces ceil(H/S) rows; the lowering crops to the
declared shape so executed activations chain exactly like planned ones.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ConvOp
from repro_torch.kernels import registry
from repro_torch.kernels.winograd_conv.ref import conv2d_ref
from repro_torch.kernels.winograd_conv.winograd_conv import winograd_conv2d


def winograd_eligible(op: ConvOp) -> bool:
    """The reference's Winograd gate (`winograd_conv/ops.py:34-36`) applied
    to a declared conv op."""
    return (op.K == 3 and op.S == 1
            and op.C_out >= registry.WINOGRAD_MIN_COUT
            and op.H_in * op.W_in >= 1024 and op.C_in >= 32)


def conv2d_op(x: torch.Tensor, w: torch.Tensor, op: ConvOp, *,
              launch=None) -> torch.Tensor:
    """SAME conv of x (B, H, W, C_in) with w (K, K, C_in, c) for the node
    `op`: Winograd when `op` passes the gate, direct otherwise.  `w` may be
    one group's slice of the op's output channels.  `launch` goes to the
    Winograd product's `hadamard_matmul`; a direct conv launches no kernel
    of the port and takes none."""
    if winograd_eligible(op):
        return winograd_conv2d(x, w, launch=launch)
    if launch is not None and not launch.is_default:
        raise ValueError(f"a direct conv takes no launch, got "
                         f"{launch.label()}")
    return conv2d_ref(x, w, stride=op.S)


# ------------------------------------------------------- registry hookup

def crop_to_declared(y: torch.Tensor, op: ConvOp) -> torch.Tensor:
    return y[:, :op.H_out, :op.W_out, :]


def _conv_kernel(x, w, op, launch=None):
    return crop_to_declared(conv2d_op(x, w, op, launch=launch), op)


def _conv_oracle(x, w, op):
    return crop_to_declared(conv2d_ref(x, w, stride=op.S), op)


registry.register_lowering("conv", kernel=_conv_kernel, oracle=_conv_oracle)
