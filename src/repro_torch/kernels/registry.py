"""Kernel registry of the port: one dispatch table for every op kind.

The port's copy of the parts of `repro.kernels.registry` that execution
needs.  It maps an op kind to

  * its JSON codec (`op_to_json` / `op_from_json`) and label, so plan
    documents written by the JAX package decode to the same ops here,
  * its **shape contract** (input / weight / output shapes, seeded weight
    init) — what `runtime.executor.PlanExecutor` needs to materialize and
    chain activations.  `init_weight` draws the same numpy arrays as the
    reference for the same seed, so the two packages run one network on
    one set of weights,
  * its **lowering** — the kernel path and the plain oracle that compute
    it, registered lazily by `kernels/*/ops.py` so that importing the
    registry builds nothing,
  * its **typed partition axes** (attention: head / kv-block; ssm:
    ssm-state), the split validation plans are decoded through, and the
    **split lowerings** that co-execute a node along such an axis.

Planning-only parts of the reference registry (predictor features, TPU
tile specs and the tile search) are not ported: a decision's TPU `tile`
travels through the port as opaque plan metadata.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.types import AttnOp, ConvOp, LinearOp, Op, SSMOp

# ------------------------------------------------------------------ kinds

#: op kind -> module that registers its lowering on import
_LOWERING_MODULES = {
    "linear": "repro_torch.kernels.split_matmul.ops",
    "conv": "repro_torch.kernels.winograd_conv.ops",
    "attention": "repro_torch.kernels.decode_attention.ops",
    "ssm": "repro_torch.kernels.ssd_chunk.ops",
}

_KIND_BY_TYPE = {LinearOp: "linear", ConvOp: "conv",
                 AttnOp: "attention", SSMOp: "ssm"}

#: per-kind kernel modes; the first entry is the default, which plan JSON
#: omits
_MODES = {"linear": (), "conv": (),
          "attention": ("streaming", "materialized"),
          "ssm": ("chunked", "recurrent")}

#: minimum output-channel count before the Winograd F(2x2,3x3) lowering is
#: dispatched (the reference's threshold, so both packages pick one
#: algorithm per node)
WINOGRAD_MIN_COUT = 128


def op_kind(op: Op) -> str:
    """The registry kind of an op — the one isinstance check of the port."""
    try:
        return _KIND_BY_TYPE[type(op)]
    except KeyError:
        raise TypeError(f"unregistered op type {type(op).__name__}") \
            from None


def default_mode(kind: str) -> str:
    modes = _MODES[kind]
    return modes[0] if modes else ""


# ------------------------------------------------------------- op codecs

def op_to_json(op: Op) -> Dict[str, Any]:
    """JSON codec of an op, keyed by registry kind (the reference's leaf
    encoding, byte for byte: network fingerprints depend on it)."""
    kind = op_kind(op)
    if kind == "linear":
        return {"kind": "linear", "L": op.L, "C_in": op.C_in,
                "C_out": op.C_out}
    if kind == "conv":
        return {"kind": "conv", "H_in": op.H_in, "W_in": op.W_in,
                "C_in": op.C_in, "C_out": op.C_out, "K": op.K, "S": op.S}
    if kind == "attention":
        d = {"kind": "attention", "H": op.H, "S": op.S, "KV": op.KV,
             "hd": op.hd, "window": op.window}
    else:
        d = {"kind": "ssm", "T": op.T, "H": op.H, "hd": op.hd, "N": op.N}
    if op.mode != default_mode(kind):
        d["mode"] = op.mode
    return d


def op_from_json(d: Dict[str, Any]) -> Op:
    if d["kind"] == "linear":
        return LinearOp(L=d["L"], C_in=d["C_in"], C_out=d["C_out"])
    if d["kind"] == "conv":
        return ConvOp(H_in=d["H_in"], W_in=d["W_in"], C_in=d["C_in"],
                      C_out=d["C_out"], K=d["K"], S=d["S"])
    if d["kind"] == "attention":
        return AttnOp(H=d["H"], S=d["S"], KV=d["KV"], hd=d["hd"],
                      window=d.get("window", 0),
                      mode=d.get("mode", default_mode("attention")))
    if d["kind"] == "ssm":
        return SSMOp(T=d["T"], H=d["H"], hd=d["hd"], N=d["N"],
                     mode=d.get("mode", default_mode("ssm")))
    raise ValueError(f"unknown op kind {d['kind']!r}")


def op_label(op: Op) -> str:
    """Human-readable label of an op (the reference's format)."""
    kind = op_kind(op)
    if kind == "linear":
        return f"linear {op.L}x{op.C_in}->{op.C_out}"
    if kind == "conv":
        return (f"conv {op.H_in}x{op.W_in}x{op.C_in}->{op.C_out} "
                f"K{op.K} S{op.S}")
    if kind == "attention":
        win = f" W{op.window}" if op.window else ""
        tail = "" if op.mode == default_mode(kind) else f" [{op.mode}]"
        return f"attention H{op.H}/kv{op.KV} hd{op.hd} S{op.S}{win}{tail}"
    tail = "" if op.mode == default_mode(kind) else f" [{op.mode}]"
    return f"ssm T{op.T} H{op.H} hd{op.hd} N{op.N}{tail}"


# ------------------------------------------------------- partition axes

#: minimum cache length before a kv-block split is offered — short caches
#: stay on the head-split/unsplit paths (the log-sum-exp merge of a
#: kv-block split is only tolerance-exact)
KV_BLOCK_MIN_S = 256

#: SSM head slices must land the output-channel boundary (h * hd) on the
#: reference's lane tile; the port keeps the reference's rule so both
#: packages accept the same plans
SSM_LANE_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """A typed partition axis of an op kind.

    ``size`` counts the natural units along the axis (query heads, cache
    positions, state heads); splits place ``n`` units on the fast side and
    ``size - n`` on the slow side, and must be multiples of
    ``granularity`` (e.g. whole GQA groups).  ``sub`` builds the sub-op a
    side computes.  ``stackable`` axes produce contiguous output-channel
    blocks (``unit_channels`` per unit) and reuse the channel-split
    gather/chaining machinery; a non-stackable axis (kv-block) merges
    partial results inside its own lowering and is always materialized.
    """

    axis: str
    size: Callable[[Op], int]
    granularity: Callable[[Op], int]
    sub: Callable[[Op, int], Op]
    stackable: bool = True
    unit_channels: Callable[[Op], int] = lambda op: 0
    available: Callable[[Op], bool] = lambda op: True


_AXES: Dict[str, Tuple[AxisSpec, ...]] = {
    "linear": (),
    "conv": (),
    "attention": (
        AxisSpec(axis="head", size=lambda op: op.H,
                 granularity=lambda op: op.H // op.KV,   # whole GQA groups
                 sub=lambda op, n: op.with_heads(n),
                 unit_channels=lambda op: op.hd,
                 available=lambda op: op.KV >= 2),       # >= 2 GQA groups
        # sliding-window masks depend on absolute cache positions and do
        # not slice into blocks: windowed ops stay off this axis
        AxisSpec(axis="kv-block", size=lambda op: op.S,
                 granularity=lambda op: max(16, op.S // 8),
                 sub=lambda op, n: op.with_cache(n), stackable=False,
                 available=lambda op: (op.S >= KV_BLOCK_MIN_S
                                       and op.window == 0)),
    ),
    "ssm": (
        AxisSpec(axis="ssm-state", size=lambda op: op.H,
                 granularity=lambda op: 1,
                 sub=lambda op, n: op.with_heads(n),
                 unit_channels=lambda op: op.hd,
                 available=lambda op: (op.H >= 2
                                       and op.hd % SSM_LANE_ALIGN == 0)),
    ),
}


def axis_spec(kind: str, axis: str) -> AxisSpec:
    get(kind)                                  # raise on unknown kinds
    for a in _AXES[kind]:
        if a.axis == axis:
            return a
    raise KeyError(f"kind {kind!r} has no partition axis {axis!r}")


def validate_axis_split(op: Op, axis: str, n_fast: int) -> AxisSpec:
    """Reject splits the executor cannot lower — GQA-group-violating head
    splits, misaligned SSM state splits, out-of-range boundaries — with
    the reference's ValueErrors, so both packages accept the same plans."""
    spec = axis_spec(op_kind(op), axis)
    size = spec.size(op)
    if not 0 <= n_fast <= size:
        raise ValueError(f"{axis} split {n_fast} out of range 0..{size} "
                         f"for {op_label(op)}")
    if 0 < n_fast < size:
        if not spec.available(op):
            raise ValueError(f"axis {axis!r} unavailable for {op_label(op)}")
        g = spec.granularity(op)
        if n_fast % g:
            raise ValueError(
                f"{axis} split {n_fast} breaks granularity {g} "
                f"(GQA groups / block size) for {op_label(op)}")
        if axis == "ssm-state" and op.hd % SSM_LANE_ALIGN:
            raise ValueError(
                f"ssm-state split needs hd % {SSM_LANE_ALIGN} == 0, "
                f"got hd={op.hd}")
    return spec


# ------------------------------------------------------- shape contracts

def _ssm_param_count(op: SSMOp) -> int:
    # flat parameter vector: b, c (T, N) each + dt (T, H) + a (H,) +
    # state0 (H, hd, N)
    return 2 * op.T * op.N + op.T * op.H + op.H + op.H * op.hd * op.N


def _fan_in(op: Op) -> int:
    if isinstance(op, LinearOp):
        return op.C_in
    if isinstance(op, ConvOp):
        return op.K * op.K * op.C_in
    if isinstance(op, AttnOp):
        return op.hd                    # keeps qk scores O(1) pre-softmax
    return op.N


@dataclasses.dataclass(frozen=True)
class KernelLowering:
    """How an op kind computes: the kernel path and the plain oracle.

    Both callables take ``(x, w, op)`` on torch tensors.  The kernel path
    launches the port's CUDA kernels for tensors on the card and runs
    their plain versions for tensors on the CPU; the oracle is plain
    PyTorch math everywhere (what `PlanExecutor.run_oracle` computes).
    """

    kernel: Callable[..., object]
    oracle: Callable[..., object]


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """What the executor needs to know about a kind."""

    kind: str
    input_shape: Callable[[Op], Tuple[int, ...]]
    weight_shape: Callable[[Op], Tuple[int, ...]]
    output_shape: Callable[[Op], Tuple[int, ...]]

    def init_weight(self, op: Op, rng: np.random.Generator) -> np.ndarray:
        """Seeded fan-in-scaled weights: the reference's draw, so one seed
        gives one set of numpy weights in both packages."""
        shape = self.weight_shape(op)
        return (rng.standard_normal(shape) /
                np.sqrt(max(1, _fan_in(op)))).astype(np.float32)


_ENTRIES: Dict[str, KernelEntry] = {
    "linear": KernelEntry(
        kind="linear",
        input_shape=lambda op: (op.L, op.C_in),
        weight_shape=lambda op: (op.C_in, op.C_out),
        output_shape=lambda op: (op.L, op.C_out),
    ),
    "conv": KernelEntry(
        kind="conv",
        input_shape=lambda op: (op.H_in, op.W_in, op.C_in),
        weight_shape=lambda op: (op.K, op.K, op.C_in, op.C_out),
        output_shape=lambda op: (op.H_out, op.W_out, op.C_out),
    ),
    "attention": KernelEntry(
        kind="attention",
        input_shape=lambda op: (1, op.H * op.hd),
        weight_shape=lambda op: (2, op.S, op.KV, op.hd),   # stacked K/V
        output_shape=lambda op: (1, op.H * op.hd),
    ),
    "ssm": KernelEntry(
        kind="ssm",
        input_shape=lambda op: (op.T, op.H * op.hd),
        weight_shape=lambda op: (_ssm_param_count(op),),
        output_shape=lambda op: (op.T, op.H * op.hd),
    ),
}

_LOWERINGS: Dict[str, KernelLowering] = {}


def kinds() -> List[str]:
    return sorted(_ENTRIES)


def get(kind: str) -> KernelEntry:
    try:
        return _ENTRIES[kind]
    except KeyError:
        raise KeyError(f"unregistered op kind {kind!r}; "
                       f"known: {kinds()}") from None


def register_lowering(kind: str, *, kernel: Callable, oracle: Callable
                      ) -> KernelLowering:
    """Called by kernels/*/ops.py at import time to hook its kernels in."""
    if kind not in _ENTRIES:
        raise KeyError(f"cannot register lowering for unknown kind {kind!r}")
    low = KernelLowering(kernel=kernel, oracle=oracle)
    _LOWERINGS[kind] = low
    return low


def get_lowering(kind: str) -> KernelLowering:
    """Resolve a kind's lowering, importing its kernel package on demand."""
    if kind not in _LOWERINGS:
        get(kind)                              # raise on unknown kinds
        module = _LOWERING_MODULES[kind]
        importlib.import_module(module)
        if kind not in _LOWERINGS:             # pragma: no cover - wiring bug
            raise RuntimeError(f"{module} did not register a lowering "
                               f"for {kind!r}")
    return _LOWERINGS[kind]


# ----------------------------------------------------- split lowerings

@dataclasses.dataclass(frozen=True)
class SplitLowering:
    """How a (kind, axis) pair co-executes across the two groups.

    ``pack(w, op, n_fast, groups)`` -> (split_plan, packed): the per-side
    parameters, built once at load.  Stackable axes return a channel
    `SplitPlan` (``c_fast = n_fast * unit_channels``), so the executor's
    gather/chaining machinery applies unchanged.

    ``run(x, packed, split, groups, op, n_fast, *, gather, x_plan)`` ->
    the output: a `GroupLocal` or a gathered tensor for stackable axes
    (mirroring `coexec_matmul`), always a materialized tensor for kv-block.
    """

    pack: Callable[..., object]
    run: Callable[..., object]


_SPLIT_LOWERINGS: Dict[Tuple[str, str], SplitLowering] = {}


def register_split_lowering(kind: str, axis: str, *, pack: Callable,
                            run: Callable) -> SplitLowering:
    """Called by kernels/*/ops.py at import time, next to its lowering."""
    axis_spec(kind, axis)                      # raise on unknown (kind, axis)
    low = SplitLowering(pack=pack, run=run)
    _SPLIT_LOWERINGS[(kind, axis)] = low
    return low


def get_split_lowering(kind: str, axis: str) -> SplitLowering:
    """Resolve a (kind, axis) split lowering, importing on demand."""
    if (kind, axis) not in _SPLIT_LOWERINGS:
        axis_spec(kind, axis)                  # raise on unknown (kind, axis)
        importlib.import_module(_LOWERING_MODULES[kind])
        if (kind, axis) not in _SPLIT_LOWERINGS:   # pragma: no cover
            raise RuntimeError(
                f"{_LOWERING_MODULES[kind]} did not register a split "
                f"lowering for {kind!r}/{axis!r}")
    return _SPLIT_LOWERINGS[(kind, axis)]
