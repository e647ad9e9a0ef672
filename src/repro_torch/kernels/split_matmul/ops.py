"""The registry lowering of the split_matmul kernel.

This module registers the "linear" lowering in the port's kernel registry
(`repro_torch.kernels.registry`): the plan executor dispatches exclusive
linear units here — full-width `split_matmul` on the kernel path, plain
``x @ w`` as the oracle.  Co-executed linear units reach `split_matmul`
through `core.coexec.coexec_matmul`, one launch per group.
"""
from __future__ import annotations

from repro_torch.kernels import registry
from repro_torch.kernels.split_matmul.split_matmul import split_matmul

def _linear_kernel(x, w, op, launch=None):
    return split_matmul(x.contiguous(), w, 0, op.C_out, launch=launch)


def _linear_oracle(x, w, op):
    return x @ w


registry.register_lowering("linear", kernel=_linear_kernel,
                           oracle=_linear_oracle)
