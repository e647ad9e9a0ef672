from repro_torch.kernels.winograd_conv.ops import conv2d_op, winograd_eligible
from repro_torch.kernels.winograd_conv.ref import conv2d_ref
from repro_torch.kernels.winograd_conv.winograd_conv import (
    hadamard_matmul, hadamard_matmul_plain, winograd_conv2d)

__all__ = ["conv2d_op", "conv2d_ref", "hadamard_matmul",
           "hadamard_matmul_plain", "winograd_conv2d", "winograd_eligible"]
