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
    registry builds nothing.

Planning-only parts of the reference registry (predictor features, typed
partition axes, TPU tile specs) are not ported: a decision's TPU `tile`
travels through the port as opaque plan metadata.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.types import AttnOp, ConvOp, LinearOp, Op, SSMOp

# ------------------------------------------------------------------ kinds

#: op kind -> module that registers its lowering on import (None: the kind
#: decodes and shape-checks, but its kernels are not ported yet)
_LOWERING_MODULES = {
    "linear": "repro_torch.kernels.split_matmul.ops",
    "conv": "repro_torch.kernels.winograd_conv.ops",
    "attention": None,
    "ssm": None,
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
        if module is None:
            raise NotImplementedError(
                f"{kind} nodes have no lowering in repro_torch yet: their "
                f"kernels (decode_attention, ssd_chunk_scan) are ROADMAP "
                f"queue 1 item 'decode nodes'")
        importlib.import_module(module)
        if kind not in _LOWERINGS:             # pragma: no cover - wiring bug
            raise RuntimeError(f"{module} did not register a lowering "
                               f"for {kind!r}")
    return _LOWERINGS[kind]
