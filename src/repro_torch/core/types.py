"""Operation descriptions for the paper's workload domain.

The paper partitions *individual* linear and convolutional operations along
their output channels (Section 2).  These dataclasses are the common currency
between the simulator, the latency predictors, the partitioner, the
planner and the executor.  They are the port's own copy of
`repro.core.types` (the port imports nothing from the JAX package), field
for field, with the same defaults, validation and accounting, so both
packages decode one plan alike and `repr(op)` is the same string in both:
the simulator seeds each op's measurement noise from it.

`AttnOp` (single-position decode attention over a KV cache) and `SSMOp` (a
chunked SSD state-space scan) are the graph IR's decoder-block kinds; they
run on the port's `decode_attention` and `ssd_chunk_scan` kernels, unsplit
or split along their typed axes (heads, cache blocks, state heads).
"""
from __future__ import annotations

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class LinearOp:
    """Y = X @ W with X: (L, C_in), W: (C_in, C_out)."""

    L: int
    C_in: int
    C_out: int

    @property
    def flops(self) -> int:
        return 2 * self.L * self.C_in * self.C_out

    @property
    def input_bytes(self) -> int:
        return 4 * self.L * self.C_in

    @property
    def weight_bytes(self) -> int:
        return 4 * self.C_in * self.C_out

    @property
    def output_bytes(self) -> int:
        return 4 * self.L * self.C_out

    def with_cout(self, c_out: int) -> "LinearOp":
        return dataclasses.replace(self, C_out=c_out)


@dataclasses.dataclass(frozen=True)
class ConvOp:
    """2D convolution, NHWC, square K x K filter, stride S, SAME padding."""

    H_in: int
    W_in: int
    C_in: int
    C_out: int
    K: int = 3
    S: int = 1

    @property
    def H_out(self) -> int:
        return max(1, self.H_in // self.S)

    @property
    def W_out(self) -> int:
        return max(1, self.W_in // self.S)

    @property
    def flops(self) -> int:
        return 2 * self.H_out * self.W_out * self.C_out * self.K * self.K * self.C_in

    @property
    def input_bytes(self) -> int:
        return 4 * self.H_in * self.W_in * self.C_in

    @property
    def weight_bytes(self) -> int:
        return 4 * self.K * self.K * self.C_in * self.C_out

    @property
    def output_bytes(self) -> int:
        return 4 * self.H_out * self.W_out * self.C_out

    def with_cout(self, c_out: int) -> "ConvOp":
        return dataclasses.replace(self, C_out=c_out)


@dataclasses.dataclass(frozen=True)
class AttnOp:
    """Single-position (decode-step) GQA attention over a length-S KV cache.

    The activation is the current token's query block, flattened to
    (1, H * hd); the KV cache is the op's parameter tensor (2, S, KV, hd)
    — state, not activation, exactly as in a serving decode step.  The op
    attends causally to positions 0..S-1 (optionally sliding-window
    limited) and produces the (1, H * hd) attended block.
    """

    H: int                    # query heads
    S: int                    # cache length (attends to positions 0..S-1)
    KV: int                   # KV heads (GQA; H % KV == 0)
    hd: int                   # head dimension
    window: int = 0           # 0 = full causal attention
    mode: str = "streaming"   # kernel mode: streaming | materialized

    def __post_init__(self):
        if self.H < 1 or self.KV < 1 or self.H % self.KV:
            raise ValueError(f"AttnOp needs H divisible by KV, "
                             f"got H={self.H} KV={self.KV}")
        if self.S < 1 or self.hd < 1:
            raise ValueError(f"AttnOp needs positive S/hd, "
                             f"got S={self.S} hd={self.hd}")
        if self.mode not in ("streaming", "materialized"):
            raise ValueError(f"AttnOp mode must be streaming|materialized, "
                             f"got {self.mode!r}")

    def with_heads(self, h: int) -> "AttnOp":
        """Sub-op attending with `h` query heads (GQA group granularity:
        `h` must be a whole number of H//KV-sized groups)."""
        group = self.H // self.KV
        if h % group:
            raise ValueError(f"head slice {h} breaks GQA groups of {group}")
        return dataclasses.replace(self, H=h, KV=h // group)

    def with_cache(self, s: int) -> "AttnOp":
        """Sub-op over a length-`s` block of the KV cache."""
        return dataclasses.replace(self, S=s)

    def with_mode(self, mode: str) -> "AttnOp":
        return dataclasses.replace(self, mode=mode)

    @property
    def flops(self) -> int:
        # q.k scores + probs.v, each 2*H*S*hd MACs-as-flops
        return 4 * self.H * self.S * self.hd

    @property
    def input_bytes(self) -> int:
        return 4 * self.H * self.hd

    @property
    def weight_bytes(self) -> int:
        return 4 * 2 * self.S * self.KV * self.hd     # the KV cache

    @property
    def output_bytes(self) -> int:
        return 4 * self.H * self.hd


@dataclasses.dataclass(frozen=True)
class SSMOp:
    """Chunked SSD (Mamba2-style) scan over T tokens.

    The activation is the inner-projected token block (T, H * hd); the
    B/C/dt projections, the per-head decay and the carried state are the
    op's parameter vector (flattened; the lowering unpacks and applies the
    stabilizing transforms).  Output is the scanned (T, H * hd) block.
    """

    T: int                    # tokens scanned
    H: int                    # SSM heads
    hd: int                   # head dimension
    N: int                    # state dimension per head
    mode: str = "chunked"     # kernel mode: chunked | recurrent

    def __post_init__(self):
        if min(self.T, self.H, self.hd, self.N) < 1:
            raise ValueError(f"SSMOp needs positive dims, got {self}")
        if self.mode not in ("chunked", "recurrent"):
            raise ValueError(f"SSMOp mode must be chunked|recurrent, "
                             f"got {self.mode!r}")

    def with_heads(self, h: int) -> "SSMOp":
        """Sub-op carrying `h` of the state heads."""
        if h < 1 or h > self.H:
            raise ValueError(f"head slice {h} out of range for H={self.H}")
        return dataclasses.replace(self, H=h)

    def with_mode(self, mode: str) -> "SSMOp":
        return dataclasses.replace(self, mode=mode)

    @property
    def flops(self) -> int:
        # per token: state update (~4*H*hd*N) + output contraction (2*H*hd*N)
        return 6 * self.T * self.H * self.hd * self.N

    @property
    def input_bytes(self) -> int:
        return 4 * self.T * self.H * self.hd

    @property
    def weight_bytes(self) -> int:
        # b, c: (T, N) each; dt: (T, H); a: (H,); state0: (H, hd, N)
        return 4 * (2 * self.T * self.N + self.T * self.H + self.H
                    + self.H * self.hd * self.N)

    @property
    def output_bytes(self) -> int:
        return 4 * self.T * self.H * self.hd


#: the output-channel-splittable kinds — the paper's partitioning domain
SplittableOp = Union[LinearOp, ConvOp]

#: every schedulable op kind (graph IR node payloads)
Op = Union[LinearOp, ConvOp, AttnOp, SSMOp]


def op_with_cout(op: SplittableOp, c_out: int) -> SplittableOp:
    return op.with_cout(c_out)
