"""The registry lowerings of the decode_attention kernel: how graph-IR
"attention" nodes execute through the `(x, w, op)` unit contract (see
kernels/registry.py) — unsplit, head-split and kv-block-split.

The node's input is the flattened (1, H*hd) query block and its parameter
the stacked (2, S, KV, hd) KV cache; decode attends to the whole recorded
cache (pos = S - 1).  Each side of a split launches `decode_attention` once
on its own group's stream.
"""
from __future__ import annotations

from repro_torch.core.coexec import (gather_lse, run_sides,
                                     split_for_groups, split_run)
from repro_torch.kernels import registry
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# ------------------------------------------------- registry unit lowering


def _query(x, op):
    return x.reshape(op.H, op.hd).contiguous()


def attention_unit_kernel(x, w, op):
    out, _ = decode_attention(_query(x, op), w[0], w[1], op.S - 1,
                              window=op.window)
    return out.reshape(1, op.H * op.hd)


def attention_unit_oracle(x, w, op):
    out = decode_attention_ref(_query(x, op), w[0], w[1], op.S - 1,
                               window=op.window)
    return out.reshape(1, op.H * op.hd)


registry.register_lowering("attention", kernel=attention_unit_kernel,
                           oracle=attention_unit_oracle)


# ------------------------------------------------ head-split co-execution
#
# Heads are KV-major (q reshapes to (KV, g, hd)), so a split at a GQA-group
# boundary owns a contiguous output-channel range: the channel-split
# gather/chaining machinery applies unchanged.  Each side attends its own
# KV heads over the full cache; per-head softmax is independent, so the
# split computes exactly what the unsplit kernel does.  Unlike the
# reference, no side is padded to the other's width.

def pack_head_split(w, op, n_fast, groups):
    """(2, S, KV, hd) stacked KV cache -> (split, (fast, slow)): each side's
    sub-op and its KV-head slice, copied once into a contiguous
    (2, S, kv_g, hd) cache."""
    axis = registry.validate_axis_split(op, "head", n_fast)
    kv_fast = n_fast // (op.H // op.KV)
    packed = ((axis.sub(op, n_fast), w[:, :, :kv_fast].contiguous()),
              (axis.sub(op, op.H - n_fast), w[:, :, kv_fast:].contiguous()))
    return (split_for_groups(op.H * op.hd, n_fast * axis.unit_channels(op),
                             groups), packed)


def run_head_split(x, packed, split, groups, op, n_fast, *, gather=True,
                   x_plan=None):
    """Head-split decode attention over the two groups: each side is the
    unit lowering of its sub-op.

    x: (1, H*hd) — or, with `x_plan`, a producer's `GroupLocal`.  Returns
    (1, H*hd) if gather else the `GroupLocal` result."""
    heads = (slice(0, n_fast), slice(n_fast, op.H))

    def side(g, x_full):
        sub, kv_cache = packed[g]
        q = x_full.reshape(op.H, op.hd)[heads[g]]
        return attention_unit_kernel(q, kv_cache, sub)

    return split_run(x, split, groups, x_plan, side, gather)


registry.register_split_lowering("attention", "head",
                                 pack=pack_head_split, run=run_head_split)


# -------------------------------------------- kv-block-split co-execution
#
# Each side computes all H heads over its block of cache positions (the
# fast side owns [0, n_fast)) and returns its normalized output with the
# per-head log-sum-exp; `gather_lse` merges the two on the caller's stream.
# The merged output is always materialized, and matches the unsplit kernel
# to tolerance, not bit for bit (the merge reassociates the softmax sums),
# which is why the registry gates this axis to S >= KV_BLOCK_MIN_S and
# window == 0.

def pack_kv_block_split(w, op, n_fast, groups):
    """(2, S, KV, hd) stacked KV cache -> (split, (fast, slow)): each side's
    sub-op and its block of cache positions, as views (each side's K and V
    stay contiguous).  The channel plan is degenerate: both sides
    contribute to every output channel."""
    axis = registry.validate_axis_split(op, "kv-block", n_fast)
    packed = ((axis.sub(op, n_fast), w[:, :n_fast]),
              (axis.sub(op, op.S - n_fast), w[:, n_fast:]))
    return split_for_groups(op.H * op.hd, op.H * op.hd, groups), packed


def run_kv_block_split(x, packed, split, groups, op, n_fast, *, gather=True,
                       x_plan=None):
    """kv-block-split decode attention: returns the materialized (1, H*hd)
    output whatever `gather` says (the merge is its sync point)."""
    def side(g, x_full):
        sub, kv_cache = packed[g]
        # window == 0 on this axis: each side attends its whole block
        return decode_attention(_query(x_full, op), kv_cache[0], kv_cache[1],
                                sub.S - 1)

    parts, events = run_sides(x, groups, x_plan, side)
    return gather_lse(parts, events).reshape(1, op.H * op.hd)


registry.register_split_lowering("attention", "kv-block",
                                 pack=pack_kv_block_split,
                                 run=run_kv_block_split)
