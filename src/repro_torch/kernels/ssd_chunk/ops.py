"""The registry lowerings of the ssd_chunk_scan kernel: how graph-IR "ssm"
nodes execute through the `(x, w, op)` unit contract (see
kernels/registry.py) — unsplit and ssm-state-split.

The node's input is the (T, H*hd) inner-projected token block and its
parameter the flat B/C/dt/a/state0 vector, in the reference's layout.
"""
from __future__ import annotations

import torch

from repro_torch.core.coexec import split_for_groups, split_run
from repro_torch.kernels import registry
from repro_torch.kernels.ssd_chunk.ref import ssd_scan_ref
from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_scan

# ------------------------------------------------- registry unit lowering


def _unpack_params(w, op):
    """Slice the flat parameter vector of an SSMOp into the scan operands,
    applying the reference's stabilizing transforms (dt bounded positive,
    a strictly negative) so a generically-initialized node never overflows
    the decay exp(dt * a).  Shared by the kernel path and the oracle."""
    t, h, hd, n = op.T, op.H, op.hd, op.N
    b, c, dt, a, state0 = torch.split(w, [t * n, t * n, t * h, h,
                                          h * hd * n])
    return (b.reshape(1, t, n), c.reshape(1, t, n),
            0.05 + 0.2 * torch.sigmoid(dt.reshape(1, t, h)),
            -(0.1 + a.abs()), state0.reshape(1, h, hd, n))


def _tokens(x, op):
    return x.reshape(1, op.T, op.H, op.hd).contiguous()


def ssm_unit_kernel(x, w, op, launch=None):
    _, y = ssd_chunk_scan(_tokens(x, op), *_unpack_params(w, op),
                          launch=launch)
    return y.reshape(op.T, op.H * op.hd)


def ssm_unit_oracle(x, w, op):
    _, y = ssd_scan_ref(_tokens(x, op), *_unpack_params(w, op))
    return y.reshape(op.T, op.H * op.hd)


registry.register_lowering("ssm", kernel=ssm_unit_kernel,
                           oracle=ssm_unit_oracle)


# ----------------------------------------------- state-split co-execution
#
# The SSD scan is independent per state head: B and C are shared, dt, a
# and the state slice head-wise, and head h owns output channels
# [h*hd, (h+1)*hd) — a contiguous range, so the channel-split
# gather/chaining machinery applies unchanged.  The stabilizing transforms
# are applied once, at pack time; the kernel computes the decay itself on
# each side, so the split matches the unsplit kernel to fp32 rounding.

def pack_state_split(w, op, n_fast, groups):
    """Flat B/C/dt/a/state0 vector -> (split, (fast, slow)): per side its
    sub-op and the transformed scan operands (b, c, dt, a, state0) of its
    heads."""
    axis = registry.validate_axis_split(op, "ssm-state", n_fast)
    b, c, dt, a, state0 = _unpack_params(w, op)

    def side(lo, hi):
        return axis.sub(op, hi - lo), (
            b, c, dt[:, :, lo:hi].contiguous(), a[lo:hi].contiguous(),
            state0[:, lo:hi].contiguous())

    packed = (side(0, n_fast), side(n_fast, op.H))
    return (split_for_groups(op.H * op.hd, n_fast * axis.unit_channels(op),
                             groups), packed)


def run_state_split(x, packed, split, groups, op, n_fast, *, gather=True,
                    x_plan=None, launch=None):
    """State-split SSD scan over the two groups.

    x: (T, H*hd) — or, with `x_plan`, a producer's `GroupLocal`.  Returns
    (T, H*hd) if gather else the `GroupLocal` result."""
    heads = (slice(0, n_fast), slice(n_fast, op.H))

    def side(g, x_full):
        sub, operands = packed[g]
        xs = x_full.reshape(1, op.T, op.H, op.hd)[:, :, heads[g]]
        _, y = ssd_chunk_scan(xs.contiguous(), *operands,
                              launch=registry.fit_launch(launch, sub))
        return y.reshape(sub.T, sub.H * sub.hd)

    return split_run(x, split, groups, x_plan, side, gather)


registry.register_split_lowering("ssm", "ssm-state", pack=pack_state_split,
                                 run=run_state_split)
