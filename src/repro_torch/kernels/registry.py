"""Kernel registry of the port: one dispatch table for every op kind.

The port's copy of `repro.kernels.registry`, less the Pallas lowerings.
It maps an op kind to

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
    ssm-state) and kernel **modes**, the split validation plans are
    decoded through, and the **split lowerings** that co-execute a node
    along such an axis,
  * its **base feature extractor**, what the latency predictors featurize
    (`core/predictor/features.py` routes through here).

It also holds the reference's TPU tile table (`TileSpec` per kind,
`resolve_tile`, the tile JSON codec) as data: a decision's `tile` is the
TPU blocking the plan was tuned for, which the static verifier
(`repro_torch.analysis`) checks; no Hopper kernel applies it.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.types import AttnOp, ConvOp, LinearOp, Op, SSMOp
from repro_torch.kernels import tiles

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
_ATTN_MODES = ("streaming", "materialized")
_SSM_MODES = ("chunked", "recurrent")
_MODES = {"linear": (), "conv": (), "attention": _ATTN_MODES,
          "ssm": _SSM_MODES}

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


def axes_for(op: Op) -> List[AxisSpec]:
    """The partition axes offered for this specific op (availability
    predicates applied — e.g. no kv-block axis for short caches)."""
    return [a for a in entry_for(op).axes if a.available(op)]


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


# ---------------------------------------------------------- tile configs
#
# The reference's TPU tile table, as data.  A plan decision's `tile` key
# is a Pallas blocking choice (VMEM-budgeted, sublane/lane aligned); it is
# the TPU contract every plan document carries, and the static verifier
# checks it here (`tile.legality`).  No Hopper kernel reads this table.

#: fp32 minimum (sublane, lane) tile — tile params aligned below these
#: cannot be laid out by Mosaic (see the Pallas TPU tiling rules)
TILE_SUBLANE = 8
TILE_LANE = 128

#: per-core VMEM budget a candidate's working set must fit in (bytes)
TILE_VMEM_BUDGET = 16 * 1024 * 1024

#: version of the Pallas kernels' blocking logic; the reference folds it
#: into its tune-cache digests, so cached tiles die when the kernels change
KERNEL_TILE_VERSION = 1


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One concrete blocking choice for a kind's Pallas kernel.

    ``values`` is an ordered tuple of ``(param, value)`` pairs in the
    kind's TileSpec order (frozen and hashable).
    """

    kind: str
    values: Tuple[Tuple[str, int], ...]

    def get(self, name: str) -> int:
        for k, v in self.values:
            if k == name:
                return v
        raise KeyError(f"tile config for {self.kind!r} has no {name!r}")

    def as_dict(self) -> Dict[str, int]:
        return dict(self.values)

    def label(self) -> str:
        return "/".join(f"{k}{v}" for k, v in self.values)


@dataclasses.dataclass(frozen=True)
class TileParam:
    """One tunable blocking parameter of a kind's kernel.

    ``extent`` names the key in :func:`tile_extents` the param blocks
    over; ``align`` is the legal multiple (sublane/lane tile).  A
    ``reduction`` param changes the accumulation grouping when varied, so
    it is pinned to its default under numerics-preserving search.  A
    ``divides`` param must divide its (clamped) extent exactly.
    """

    name: str
    extent: str
    align: int
    default: int
    candidates: Tuple[int, ...]
    reduction: bool = False
    divides: bool = False


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """The legal tile-config space of one op kind.

    This is the *validator* the reference's Pallas kernels defer to:
    `clamp_tile` clamps oversize tiles to the padded problem extents;
    `validate_tile` rejects misaligned / oversize / over-budget configs
    with ValueError.
    """

    kind: str
    params: Tuple[TileParam, ...]
    #: approximate per-grid-step VMEM working set (bytes) of a config
    vmem_bytes: Callable[[Dict[str, int], Dict[str, int]], int]

    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    def param(self, name: str) -> TileParam:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"kind {self.kind!r} has no tile param {name!r}")

    def config(self, **values: int) -> TileConfig:
        """Build a TileConfig in spec order; unknown names raise, missing
        params take their (unclamped) declared defaults."""
        unknown = set(values) - set(self.names())
        if unknown:
            raise ValueError(f"unknown tile param(s) {sorted(unknown)} "
                             f"for kind {self.kind!r}; "
                             f"legal: {list(self.names())}")
        return TileConfig(self.kind, tuple(
            (p.name, int(values.get(p.name, p.default)))
            for p in self.params))

    def default_config(self, op: Op = None) -> TileConfig:
        """The hardcoded-default config; clamped to ``op``'s extents when
        an op is given."""
        cfg = self.config()
        return cfg if op is None else self.clamp_tile(cfg, tile_extents(op))

    def clamp_tile(self, tile: TileConfig,
                   extents: Dict[str, int]) -> TileConfig:
        """Clamp oversize params down to the padded problem extent, then
        validate."""
        clamped = {}
        for name, v in tile.values:
            p = self.param(name)
            lim = _round_up(max(1, extents[p.extent]), p.align)
            clamped[name] = min(int(v), lim)
        cfg = self.config(**clamped)
        self.validate_tile(cfg, extents)
        return cfg

    def validate_tile(self, tile: TileConfig,
                      extents: Dict[str, int] = None) -> TileConfig:
        """Strict legality check — raises ValueError instead of rewriting.

        Checks: positive, aligned to the min tile, under the VMEM budget,
        and (when extents are given) not exceeding the padded extent plus
        any divides-extent constraint.
        """
        if tile.kind != self.kind:
            raise ValueError(f"tile config kind {tile.kind!r} does not "
                             f"match spec kind {self.kind!r}")
        vals = tile.as_dict()
        if set(vals) != set(self.names()):
            raise ValueError(
                f"tile config params {sorted(vals)} != spec params "
                f"{sorted(self.names())} for kind {self.kind!r}")
        for p in self.params:
            v = vals[p.name]
            if v <= 0:
                raise ValueError(f"{self.kind} tile {p.name}={v} must be "
                                 f"positive")
            if v % p.align:
                raise ValueError(
                    f"{self.kind} tile {p.name}={v} breaks the minimum "
                    f"tile: must be a multiple of {p.align}")
            if extents is not None:
                lim = _round_up(max(1, extents[p.extent]), p.align)
                if v > lim:
                    raise ValueError(
                        f"{self.kind} tile {p.name}={v} exceeds the padded "
                        f"{p.extent} extent {lim}; clamp via "
                        f"TileSpec.clamp_tile instead of relying on the "
                        f"kernel to rewrite it")
                if p.divides and extents[p.extent] % v:
                    raise ValueError(
                        f"{self.kind} tile {p.name}={v} must divide "
                        f"{p.extent}={extents[p.extent]}")
        if extents is not None:
            budget = self.vmem_bytes(vals, extents)
            if budget > TILE_VMEM_BUDGET:
                raise ValueError(
                    f"{self.kind} tile {tile.label()} working set "
                    f"{budget} B exceeds the VMEM budget "
                    f"{TILE_VMEM_BUDGET} B")
        return tile

    def configs(self, op: Op, *,
                preserve_numerics: bool = True) -> List[TileConfig]:
        """The legal, deduplicated candidate grid for ``op``.

        With ``preserve_numerics`` (the default, and the only mode the
        reference's autotuner selects from unless told otherwise) every
        reduction-axis param is pinned to its default-resolved value, so
        each candidate computes bit-identical fp32 results to the default
        config — varying only how the *output* space is tiled.  With
        ``preserve_numerics=False`` the reduction params are searched too;
        those candidates are tolerance-exact, not bit-identical.
        """
        extents = tile_extents(op)
        default = self.default_config(op)
        grids: List[List[int]] = []
        for p in self.params:
            if p.reduction and preserve_numerics:
                grids.append([default.get(p.name)])
            else:
                grids.append(sorted(set(p.candidates) | {p.default}))
        out: List[TileConfig] = []
        seen = set()
        for combo in _product(grids):
            try:
                cfg = self.clamp_tile(
                    self.config(**dict(zip(self.names(), combo))), extents)
            except ValueError:
                continue
            if cfg not in seen:
                seen.add(cfg)
                out.append(cfg)
        if default not in seen:                  # pragma: no cover - safety
            out.insert(0, default)
        return out


def _product(grids: List[List[int]]) -> List[Tuple[int, ...]]:
    combos: List[Tuple[int, ...]] = [()]
    for grid in grids:
        combos = [c + (v,) for c in combos for v in grid]
    return combos


def _linear_vmem(v: Dict[str, int], extents: Dict[str, int]) -> int:
    # x block + w block + fp32 acc scratch + out block
    return 4 * (v["bm"] * v["bk"] + v["bk"] * v["bn"] + 2 * v["bm"] * v["bn"])


def _conv_vmem(v: Dict[str, int], extents: Dict[str, int]) -> int:
    # 16 Winograd points share the (bm, bn) tile: u + w + acc + out per point
    return 16 * 4 * (v["bm"] * v["bk"] + v["bk"] * v["bn"] +
                     2 * v["bm"] * v["bn"])


def _attn_vmem(v: Dict[str, int], extents: Dict[str, int]) -> int:
    # k + v cache blocks dominate; heads/hd are bounded small
    return 2 * 4 * v["bs"] * TILE_LANE


def _ssm_vmem(v: Dict[str, int], extents: Dict[str, int]) -> int:
    # decay matrix (L, L) + chunk-local b/c/x blocks
    return 4 * (v["chunk"] * v["chunk"] + 4 * v["chunk"] * TILE_LANE)


_TILE_SPECS: Dict[str, TileSpec] = {
    "linear": TileSpec(
        kind="linear",
        params=(
            TileParam("bm", "m", TILE_SUBLANE, 128, (8, 64, 128, 256)),
            TileParam("bn", "n", TILE_LANE, 128, (128, 256, 512)),
            TileParam("bk", "k", TILE_LANE, 512, (128, 256, 512, 1024),
                      reduction=True),
        ),
        vmem_bytes=_linear_vmem,
    ),
    "conv": TileSpec(
        kind="conv",
        params=(
            TileParam("bm", "m", TILE_SUBLANE, 128, (8, 64, 128, 256)),
            TileParam("bn", "n", TILE_LANE, 128, (128, 256)),
            TileParam("bk", "k", TILE_LANE, 256, (128, 256, 512),
                      reduction=True),
        ),
        vmem_bytes=_conv_vmem,
    ),
    "attention": TileSpec(
        kind="attention",
        params=(
            TileParam("bs", "s", TILE_LANE, 512, (128, 256, 512, 1024, 2048),
                      reduction=True),
        ),
        vmem_bytes=_attn_vmem,
    ),
    "ssm": TileSpec(
        kind="ssm",
        params=(
            TileParam("chunk", "t", 1, 256, (64, 128, 256, 512),
                      reduction=True, divides=True),
        ),
        vmem_bytes=_ssm_vmem,
    ),
}


def tile_spec(kind: str) -> TileSpec:
    get(kind)                                    # raise on unknown kinds
    return _TILE_SPECS[kind]


def tile_extents(op: Op) -> Dict[str, int]:
    """The problem extents each tile param blocks over, from the op's
    declared shapes (batch-1; runtime extents can only be larger)."""
    kind = op_kind(op)
    if kind == "linear":
        return {"m": op.L, "n": op.C_out, "k": op.C_in}
    if kind == "conv":
        th = -(-op.H_out // 2)
        tw = -(-op.W_out // 2)
        return {"m": th * tw, "n": op.C_out, "k": op.C_in}
    if kind == "attention":
        return {"s": op.S}
    return {"t": op.T}


def default_tile(op: Op) -> TileConfig:
    """The default-resolved (clamped) config — what an untuned plan runs."""
    return tile_spec(op_kind(op)).default_config(op)


def resolve_tile(op: Op, tile: TileConfig = None) -> TileConfig:
    """The config the reference's Pallas kernel runs: the clamped default
    when ``tile`` is None, else ``tile`` strictly validated against the
    op's declared extents."""
    spec = tile_spec(op_kind(op))
    if tile is None:
        return spec.default_config(op)
    return spec.validate_tile(tile, tile_extents(op))


def tile_to_json(tile: TileConfig) -> Dict[str, int]:
    """JSON codec of a tile config — plain param->value mapping; the kind
    is implied by the enclosing decision's op."""
    return {k: v for k, v in tile.values}


def tile_from_json(kind: str, d: Dict[str, int]) -> TileConfig:
    spec = tile_spec(kind)
    if set(d) != set(spec.names()):
        raise ValueError(f"tile JSON params {sorted(d)} != spec params "
                         f"{sorted(spec.names())} for kind {kind!r}")
    return spec.config(**{k: int(v) for k, v in d.items()})


# ------------------------------------------------------- Hopper launches
#
# The port's own launch table (`kernels.tiles`): what the Hopper kernels
# read.  A launch is validated against the extents of the call it is given
# to; these are an op's, from its declared batch-1 shapes.

def launch_extents(op: Op) -> Dict[str, int]:
    """The extents a launch of the op's Hopper kernel is checked against:
    the GEMV or tiled product's (m, k, n); the Winograd product's (p, k, n)
    for a conv that takes Winograd (none for a direct conv, which launches
    no kernel of the port); the attended tiles of a decode attention at
    pos = S - 1; the SSD scan's (t, hd, n)."""
    kind = op_kind(op)
    if kind == "linear":
        return {"m": op.L, "k": op.C_in, "n": op.C_out}
    if kind == "conv":
        from repro_torch.kernels.winograd_conv.ops import winograd_eligible
        if not winograd_eligible(op):
            return {}
        return {"p": -(-op.H_in // 2) * -(-op.W_in // 2), "k": op.C_in,
                "n": op.C_out}
    if kind == "attention":
        attended = min(op.S, op.window) if op.window else op.S
        return {"tiles": -(-attended // tiles.ATTN_TILE)}
    return {"t": op.T, "hd": op.hd, "n": op.N}


def fit_launch(launch, op: Op, **extents: int) -> tiles.Launch:
    """A launch tuned for `op` fitted to one side of its split: clamped
    (`LaunchSpec.clamp`) to the op's launch extents with `extents`
    overriding them (a channel side's width `n`), or to a typed side's
    sub-op's where `op` is that sub-op."""
    kind = op_kind(op)
    return tiles.launch_spec(kind).clamp(
        tiles.as_launch(kind, launch), {**launch_extents(op), **extents})


# ------------------------------------------------------- shape contracts

def _ssm_param_count(op: SSMOp) -> int:
    # flat parameter vector: b, c (T, N) each + dt (T, H) + a (H,) +
    # state0 (H, hd, N)
    return 2 * op.T * op.N + op.T * op.H + op.H + op.H * op.hd * op.N


# the predictors' per-kind base features (the reference's, value for
# value: the feature matrices, hence the trees, must agree)

def _linear_base_features(op: LinearOp) -> List[float]:
    return [op.L, op.C_in, op.C_out,
            math.log(max(op.flops, 1)), math.log(max(op.weight_bytes, 1))]


def _conv_base_features(op: ConvOp) -> List[float]:
    return [op.H_in, op.W_in, op.C_in, op.C_out, op.K, op.S,
            math.log(max(op.flops, 1)), math.log(max(op.weight_bytes, 1))]


def _attn_base_features(op: AttnOp) -> List[float]:
    return [op.H, op.S, op.KV, op.hd, op.window,
            math.log(max(op.flops, 1)), math.log(max(op.weight_bytes, 1)),
            float(_ATTN_MODES.index(op.mode))]


def _ssm_base_features(op: SSMOp) -> List[float]:
    return [op.T, op.H, op.hd, op.N,
            math.log(max(op.flops, 1)), math.log(max(op.weight_bytes, 1)),
            float(_SSM_MODES.index(op.mode))]


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

    Both callables take ``(x, w, op)`` on torch tensors; the kernel path
    also ``launch=`` (a `kernels.tiles.Launch` for the op's kernel, None
    for the planner's choice).  It launches the port's CUDA kernels for
    tensors on the card and runs their plain versions for tensors on the
    CPU; the oracle is plain PyTorch math everywhere (what
    `PlanExecutor.run_oracle` computes).
    """

    kernel: Callable[..., object]
    oracle: Callable[..., object]


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """What the planner and the executor need to know about a kind."""

    kind: str
    input_shape: Callable[[Op], Tuple[int, ...]]
    weight_shape: Callable[[Op], Tuple[int, ...]]
    output_shape: Callable[[Op], Tuple[int, ...]]
    #: the latency predictors' base feature vector of an op
    base_features: Callable[[Op], List[float]]
    #: whether a plan may split the op's output channels across the two
    #: groups; kinds with ``splittable=False`` split along their typed
    #: ``axes`` instead
    splittable: bool = True

    @property
    def axes(self) -> Tuple[AxisSpec, ...]:
        """The kind's typed partition axes (empty for channel-split
        kinds)."""
        return _AXES[self.kind]

    @property
    def modes(self) -> Tuple[str, ...]:
        """Kernel modes the planner may choose between; the first is the
        default (empty for kinds without a mode dimension)."""
        return _MODES[self.kind]

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
        base_features=_linear_base_features,
    ),
    "conv": KernelEntry(
        kind="conv",
        input_shape=lambda op: (op.H_in, op.W_in, op.C_in),
        weight_shape=lambda op: (op.K, op.K, op.C_in, op.C_out),
        output_shape=lambda op: (op.H_out, op.W_out, op.C_out),
        base_features=_conv_base_features,
    ),
    "attention": KernelEntry(
        kind="attention",
        input_shape=lambda op: (1, op.H * op.hd),
        weight_shape=lambda op: (2, op.S, op.KV, op.hd),   # stacked K/V
        output_shape=lambda op: (1, op.H * op.hd),
        base_features=_attn_base_features,
        splittable=False,
    ),
    "ssm": KernelEntry(
        kind="ssm",
        input_shape=lambda op: (op.T, op.H * op.hd),
        weight_shape=lambda op: (_ssm_param_count(op),),
        output_shape=lambda op: (op.T, op.H * op.hd),
        base_features=_ssm_base_features,
        splittable=False,
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


def entry_for(op: Op) -> KernelEntry:
    return get(op_kind(op))


def is_splittable(op: Op) -> bool:
    """Whether the partitioner may channel-split this op (see
    KernelEntry)."""
    return entry_for(op).splittable


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

    ``run(x, packed, split, groups, op, n_fast, *, gather, x_plan,
    launch)`` -> the output: a `GroupLocal` or a gathered tensor for
    stackable axes (mirroring `coexec_matmul`), always a materialized
    tensor for kv-block.  `launch` is the op's tuned launch; each side
    fits it to its own sub-op (`fit_launch`).
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
