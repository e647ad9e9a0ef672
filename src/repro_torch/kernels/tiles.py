"""Launch-parameter validation for the port's kernels, and the Hopper
launch table the autotuner searches.

Two parts, importing nothing:

* `round_up`, `check_tile` and `check_chunk`: the port's copy of the
  reference's kernel-side tile checks (`repro.kernels.tiles`), value for
  value and message for message: a tile param left as None resolves to its
  default clamped to the problem extent, and an explicit value that is
  misaligned or oversize raises ValueError instead of being rewritten.

* The Hopper launch table: one `LaunchSpec` per op kind, holding the legal
  values of its kernel's launch parameters (`split_matmul`'s split-K
  `splits` and tiled-product `bm`/`bn`, `hadamard_matmul`'s `bm`/`bn`,
  `decode_attention`'s `run_tiles`, `ssd_chunk_scan`'s `chunk`).  A
  `Launch` names some of them; a parameter it leaves out is what the
  kernel's own launch planner picks (`plan_launch`, `plan_hadamard`,
  `plan_attention`, `plan_ssd`), so the empty launch is the default and an
  untuned call launches exactly what it launched before the table existed.
  Each parameter is marked output-tiling or reduction-axis, as the
  reference's `TileParam(reduction=True)` is: varying an output-tiling one
  changes which block computes an output and nothing about how it is
  summed, so the result is bit-identical; a reduction-axis one regroups a
  sum and is tolerance-exact.

  What bounds a value is the card's, not the TPU's: a block's shared
  memory (`SMEM_PER_BLOCK`, 227 KB opt-in); the problem's padded extent;
  the tile sizes a kernel has an instantiation of (the Winograd tiles'
  resident blocks fit an SM's 228 KB together, by the kernel's launch
  bounds); and the exact-split rule (`splits` chunks of K with none
  empty).  How many blocks fill one
  wave is the planners' business, not a legality rule: the second passes
  of `split_matmul` and `decode_attention` are separate launches, so no
  block waits on another and any grid the rules above allow is correct.

The plan document's `tile` key is the reference's TPU blocking and is
never a `Launch`: tuned launches travel beside the plan
(`runtime/autotune.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union


def round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def check_tile(name: str, v, default: int, extent: int, align: int,
               lim_align: int = None) -> int:
    """Default-or-validate one tile param against a problem extent.

    None -> ``min(default, round_up(extent, lim_align))`` (the legal
    clamped default).  An explicit value must be a positive multiple of
    ``align`` no larger than the padded extent, else ValueError.
    ``lim_align`` (default ``align``) sets the padding granularity of the
    extent cap separately from the value's own alignment.
    """
    lim = round_up(max(1, extent), lim_align if lim_align else align)
    if v is None:
        return min(default, lim)
    v = int(v)
    if v <= 0 or v % align or v > lim:
        raise ValueError(
            f"illegal tile {name}={v} for extent {extent}: must be a "
            f"positive multiple of {align} and <= {lim} (clamp via "
            f"kernels.registry.TileSpec.clamp_tile)")
    return v


def check_chunk(name: str, v, default: int, extent: int) -> int:
    """Default-or-validate a chunk-style param that must divide its extent.

    None -> ``min(default, extent)``; explicit values must be positive,
    <= extent and divide it exactly, else ValueError.
    """
    if v is None:
        v = min(default, extent)
    v = int(v)
    if v <= 0 or v > extent:
        raise ValueError(
            f"illegal tile {name}={v} for extent {extent}: must be in "
            f"1..{extent} (clamp via kernels.registry.TileSpec.clamp_tile)")
    if extent % v:
        raise ValueError(
            f"illegal tile {name}={v}: must divide extent {extent} exactly")
    return v


# ------------------------------------------------------ the card's limits

#: version of the Hopper launch table; folded into the port's tune-cache
#: digests and tag, so cached launches die when the kernels change shape
HOPPER_KERNEL_TILE_VERSION = 1

#: shared memory one Hopper block may use (the opt-in maximum, 227 KB)
SMEM_PER_BLOCK = 232448

# What the launch table and the kernels' planners share.  The kernel
# modules take these from here (under their old names), so the table and
# the planners cannot drift.

#: split_matmul: the most rows of X its GEMV holds per block (M > 8 takes
#: the tiled product), and the GEMV's static shared memory at its widest
#: tile (8 warps' partial sums of 256 bf16 columns, fp32)
MAX_GEMV_ROWS = 8
GEMV_STATIC_SMEM = 8 * 256 * 4
#: split_matmul's tiled product: the block edges it has instantiations of
GEMM_EDGES = (64, 128)

#: hadamard_matmul: its tiles, (rows, columns) of M[g] per block, with the
#: blocks of each an SM holds at once (the kernel's launch bounds)
HADAMARD_TILES = {(128, 128): 2, (128, 64): 3, (64, 128): 3}

#: decode_attention: cache positions per tile (a run is whole tiles)
ATTN_TILE = 32

#: ssd_chunk_scan: the chunk kernel's default tokens per chunk, and the
#: most tokens the decode kernel steps (longer scans take the chunk kernel)
SSD_CHUNK = 64
SSD_DECODE_T_MAX = 16


def ssd_smem_bytes(hd: int, n: int, chunk: int) -> int:
    """Shared memory of one SSD chunk-kernel block: the (hd, N+1) state,
    (L, hd) x * dt, (L, N+1) B and C, the (L, L) tile and four (L,)
    vectors, in fp32."""
    return 4 * (hd * (n + 1) + chunk * hd + 2 * chunk * (n + 1)
                + chunk * chunk + 4 * chunk)


# ---------------------------------------------------------------- launches

@dataclasses.dataclass(frozen=True)
class Launch:
    """Launch parameters of one kernel call, in the kind's spec order.

    ``values`` holds only the parameters the launch fixes; the others are
    the kernel planner's choice, so ``Launch(kind)`` (no values) is the
    default launch.  Frozen and hashable, like the reference's
    `TileConfig`."""

    kind: str
    values: Tuple[Tuple[str, int], ...] = ()

    def get(self, name: str) -> Optional[int]:
        for k, v in self.values:
            if k == name:
                return v
        return None

    def as_dict(self) -> Dict[str, int]:
        return dict(self.values)

    @property
    def is_default(self) -> bool:
        return not self.values

    def label(self) -> str:
        if not self.values:
            return "default"
        return "/".join(f"{k}{v}" for k, v in self.values)


@dataclasses.dataclass(frozen=True)
class LaunchParam:
    """One launch parameter of a kind's kernel.

    ``extent`` names the key of the call's extents it may not exceed
    (padded to ``align``); ``applies`` says for which extents the kernel
    reads it at all (the GEMV or the tiled product, the chunk kernel or
    the decode kernel).  A ``closed`` parameter takes only its
    ``candidates`` (the instantiations the kernel has); an open one any
    aligned value, and ``candidates`` are what the autotuner searches.
    ``reduction`` marks a parameter that regroups a sum: under
    numerics-preserving search it stays at the planner's choice."""

    name: str
    extent: str
    align: int
    candidates: Tuple[int, ...]
    applies: Callable[[Mapping[str, int]], bool]
    reduction: bool = False
    closed: bool = False


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """The legal launches of one op kind's kernel.

    `validate` checks an explicit launch against a call's extents and
    raises ValueError, rewriting nothing (the wrappers call it); `clamp`
    is where a launch tuned for a whole op is fitted to one side of a
    split; `configs` is the autotuner's candidate grid.  ``joint`` names
    parameters a launch gives together or not at all (a tile's two edges);
    ``check`` holds the kind's rules over several values at once (shared
    memory, instantiated pairs, exact splits), raising ValueError."""

    kind: str
    kernel: str
    params: Tuple[LaunchParam, ...]
    check: Callable[[Dict[str, int], Mapping[str, int]], None]
    joint: Tuple[str, ...] = ()

    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    def param(self, name: str) -> LaunchParam:
        for p in self.params:
            if p.name == name:
                return p
        raise ValueError(f"{self.kernel} has no launch parameter {name!r}; "
                         f"legal: {list(self.names())}")

    def default(self) -> Launch:
        return Launch(self.kind)

    def config(self, **values: int) -> Launch:
        """A Launch in spec order (unknown names raise)."""
        for name in values:
            self.param(name)
        return Launch(self.kind, tuple(
            (p.name, int(values[p.name])) for p in self.params
            if p.name in values))

    def validate(self, launch: Launch, extents: Mapping[str, int]) -> Launch:
        """Strict legality of `launch` for a call of these extents: each
        value applies to the kernel the call takes, is positive, aligned,
        an instantiated value where the parameter is closed, no larger than
        the padded extent; joint parameters come together; and the kind's
        rules hold.  Raises ValueError, never rewrites."""
        if launch.kind != self.kind:
            raise ValueError(f"a {launch.kind} launch given to "
                             f"{self.kernel}")
        vals = launch.as_dict()
        for name, v in vals.items():
            p = self.param(name)
            where = f"{self.kernel} launch {name}={v}"
            if not p.applies(extents):
                raise ValueError(f"{where} does not apply to a call of "
                                 f"extents {dict(extents)}")
            lim = round_up(max(1, extents[p.extent]), p.align)
            if v <= 0 or v % p.align or v > lim:
                raise ValueError(f"illegal {where}: must be a positive "
                                 f"multiple of {p.align} and <= {lim} (the "
                                 f"padded {p.extent} extent "
                                 f"{extents[p.extent]})")
            if p.closed and v not in p.candidates:
                raise ValueError(f"illegal {where}: the kernel has "
                                 f"instantiations for {list(p.candidates)}")
        given = [n for n in self.joint if n in vals]
        if given and len(given) != len(self.joint):
            raise ValueError(f"{self.kernel} launch gives {given}: "
                             f"{list(self.joint)} go together or not at all")
        if vals:
            self.check(vals, extents)
        return launch

    def clamp(self, launch: Launch, extents: Mapping[str, int]) -> Launch:
        """`launch` fitted to a call of these extents (one side of a
        split): parameters the call's kernel does not read are dropped, the
        others clamped to the padded extent (closed ones to the largest
        instantiation under it, splits to the count the kernel really
        launches); where the result is still illegal, the planner's choice
        is taken instead."""
        vals = {}
        for name, v in launch.values:
            p = self.param(name)
            if not p.applies(extents):
                continue
            lim = round_up(max(1, extents[p.extent]), p.align)
            v = min(v, lim)
            if p.closed:
                fits = [c for c in p.candidates if c <= v]
                if not fits:
                    continue
                v = max(fits)
            vals[name] = v
        if "splits" in vals:
            vals["splits"] = exact_splits(extents["k"], vals["splits"])
        try:
            return self.validate(self.config(**vals), extents)
        except ValueError:
            return self.default()

    def configs(self, extents: Mapping[str, int], *,
                preserve_numerics: bool = True) -> List[Launch]:
        """The legal candidate grid for a call of these extents, the
        default first.  With ``preserve_numerics`` (the autotuner's
        default) reduction-axis parameters stay at the planner's choice,
        so every candidate computes bit-identical fp32 results to the
        default; without, they are searched too (tolerance-exact)."""
        grids: List[List[Tuple[str, int]]] = []
        for p in self.params:
            if not p.applies(extents) or (p.reduction and preserve_numerics):
                continue
            grids.append([(p.name, v) for v in p.candidates])
        out = [self.default()]
        for combo in (_product(grids) if grids else []):
            try:
                cand = self.validate(self.config(**dict(combo)), extents)
            except ValueError:
                continue
            if cand not in out:
                out.append(cand)
        return out


def _product(grids):
    combos = [[]]
    for grid in grids:
        combos = [c + [v] for c in combos for v in grid]
    return combos


def exact_splits(k: int, splits: int) -> int:
    """The split-K count the GEMV launches for `splits` requested over K
    rows: chunks of ceil(K / splits) rows, the last one possibly shorter,
    none empty."""
    splits = max(1, min(splits, k))
    return -(-k // -(-k // splits))


# ------------------------------------------------------------ the table

def _gemv(e: Mapping[str, int]) -> bool:
    return e["m"] <= MAX_GEMV_ROWS


def _gemv_rows(m: int) -> int:
    return 1 << max(0, m - 1).bit_length()


def _check_linear(v: Dict[str, int], e: Mapping[str, int]) -> None:
    if "splits" in v:
        s, k = v["splits"], e["k"]
        if exact_splits(k, s) != s:
            raise ValueError(f"illegal split_matmul launch splits={s}: "
                             f"chunks of {-(-k // s)} of K = {k} rows make "
                             f"{exact_splits(k, s)} splits")
        stage = 4 * _gemv_rows(e["m"]) * -(-k // s)
        if stage > SMEM_PER_BLOCK - GEMV_STATIC_SMEM:
            raise ValueError(f"illegal split_matmul launch splits={s}: its "
                             f"X stage of {stage} B is over the "
                             f"{SMEM_PER_BLOCK - GEMV_STATIC_SMEM} B a block "
                             f"has left")


def _check_conv(v: Dict[str, int], e: Mapping[str, int]) -> None:
    tile = (v["bm"], v["bn"])
    if tile not in HADAMARD_TILES:
        raise ValueError(f"illegal hadamard_matmul launch bm={tile[0]}/"
                         f"bn={tile[1]}: its tiles are "
                         f"{sorted(HADAMARD_TILES)}")


def _check_attention(v: Dict[str, int], e: Mapping[str, int]) -> None:
    if -(-e["tiles"] // v["run_tiles"]) > 65535:
        raise ValueError(f"illegal decode_attention launch run_tiles="
                         f"{v['run_tiles']}: over 65535 runs per KV head")


def _check_ssm(v: Dict[str, int], e: Mapping[str, int]) -> None:
    smem = ssd_smem_bytes(e["hd"], e["n"], v["chunk"])
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"illegal ssd_chunk_scan launch chunk={v['chunk']}:"
                         f" {smem} B of shared memory at hd={e['hd']}, "
                         f"N={e['n']}, over the {SMEM_PER_BLOCK} B a block "
                         f"may use")


_SPECS: Dict[str, LaunchSpec] = {
    "linear": LaunchSpec(
        kind="linear", kernel="split_matmul",
        params=(
            # the GEMV's split-K factor: regroups the sum over K
            LaunchParam("splits", "k", 1,
                        (1, 2, 4, 8, 16, 32, 64, 128, 256), _gemv,
                        reduction=True),
            # the tiled product's block: every output is summed over K in
            # the same order whatever block computes it
            LaunchParam("bm", "m", 64, GEMM_EDGES,
                        lambda e: not _gemv(e), closed=True),
            LaunchParam("bn", "n", 64, GEMM_EDGES,
                        lambda e: not _gemv(e), closed=True),
        ),
        check=_check_linear, joint=("bm", "bn")),
    "conv": LaunchSpec(
        kind="conv", kernel="hadamard_matmul",
        params=(
            LaunchParam("bm", "p", 64, (64, 128), lambda e: "p" in e,
                        closed=True),
            LaunchParam("bn", "n", 64, (64, 128), lambda e: "p" in e,
                        closed=True),
        ),
        check=_check_conv, joint=("bm", "bn")),
    "attention": LaunchSpec(
        kind="attention", kernel="decode_attention",
        params=(
            # whole tiles per run: the runs' partials are merged in pass 2
            LaunchParam("run_tiles", "tiles", 1, (1, 2, 4, 8, 16, 32, 64),
                        lambda e: True, reduction=True),
        ),
        check=_check_attention),
    "ssm": LaunchSpec(
        kind="ssm", kernel="ssd_chunk_scan",
        params=(
            # tokens per chunk of the chunk kernel: regroups the scan
            LaunchParam("chunk", "t", 1, (8, 16, 32, 64, 128),
                        lambda e: e["t"] > SSD_DECODE_T_MAX, reduction=True),
        ),
        check=_check_ssm),
}


def launch_spec(kind: str) -> LaunchSpec:
    try:
        return _SPECS[kind]
    except KeyError:
        raise KeyError(f"no Hopper launch spec for kind {kind!r}; known: "
                       f"{sorted(_SPECS)}") from None


def as_launch(kind: str, launch: Union[Launch, Mapping[str, int], None]
              ) -> Launch:
    """`launch` as a Launch of `kind` (None is the default; a mapping
    names parameters)."""
    spec = launch_spec(kind)
    if launch is None:
        return spec.default()
    if isinstance(launch, Launch):
        return launch
    return spec.config(**dict(launch))


def check_launch(kind: str, launch, extents: Mapping[str, int]) -> Launch:
    """The wrappers' entry: `launch` (None, a Launch or a mapping)
    validated for a call of these extents; raises ValueError."""
    return launch_spec(kind).validate(as_launch(kind, launch), extents)


def launch_to_json(launch: Launch) -> Dict[str, int]:
    """JSON codec of a launch: its fixed parameters ({} is the default);
    the kind is the op's."""
    return {k: v for k, v in launch.values}


def launch_from_json(kind: str, d: Mapping[str, int]) -> Launch:
    if not isinstance(d, Mapping):
        raise TypeError(f"a launch is a JSON object, got {type(d).__name__}")
    return launch_spec(kind).config(**{k: int(v) for k, v in d.items()})
