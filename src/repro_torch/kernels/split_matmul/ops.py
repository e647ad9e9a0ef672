"""The registry lowerings of the split_matmul kernel: unsplit and
channel-split.

This module registers the "linear" lowering in the port's kernel registry
(`repro_torch.kernels.registry`): full-width `split_matmul` on the kernel
path, plain ``x @ w`` as the oracle.  It also registers the ("linear",
"channel") split lowering, which packs the weight's output channels per
group and runs `core.coexec.coexec_matmul`, one launch per group.
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


# --------------------------------------------- channel-split co-execution
#
# `core.coexec` imports this package's kernel: both functions import it at
# call time.

def pack_channel_split(w, op, n_fast, groups):
    """(..., C_out) weight -> (split, packed): the fast group owns the first
    `n_fast` output channels (`split_for_groups`), each group's slice
    zero-padded into one (2, ..., c_pad) tensor (`pack_weights`).  Shared
    by the conv lowering."""
    from repro_torch.core.coexec import pack_weights, split_for_groups
    split = split_for_groups(op.C_out, n_fast, groups)
    return split, pack_weights(w, split)


def _run_channel_split(x, packed, split, groups, op, n_fast, *, gather=True,
                       x_plan=None, launch=None):
    from repro_torch.core.coexec import coexec_matmul
    return coexec_matmul(x, packed, split, groups, gather=gather,
                         x_plan=x_plan, launch=launch)


registry.register_split_lowering("linear", "channel",
                                 pack=pack_channel_split,
                                 run=_run_channel_split)
