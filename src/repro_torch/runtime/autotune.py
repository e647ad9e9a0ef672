"""Measured Hopper launch search, cached on disk.

The planner prices *which side runs how much* of an op; this module picks
*how the op's Hopper kernel is launched*.  `autotune(op)` times every
candidate of the kind's launch grid (`kernels.tiles.LaunchSpec.configs`
over the op's `registry.launch_extents`) on the card and returns the
fastest, by default searching only the numerics-preserving grid: its
candidates vary how the output is tiled and leave every reduction-axis
parameter at the planner's choice, so the winner computes bit-identical
fp32 results to the default launch.  `preserve_numerics=False` searches
the reduction-axis parameters too (split-K factors, runs per KV head,
chunk lengths); those candidates are tolerance-exact, not bit-identical,
and are never selected unless asked.

This is the port's counterpart of `repro.runtime.autotune`, with its names
and its digest discipline, and one difference of substance.  The
reference attaches its winners to the plan's decisions as TPU
`TileConfig`s (the `tile` key); the port's winners are Hopper `Launch`es,
which no plan document carries.  A tuned compile's plan document is the
untuned one with the provenance `tune` tag set to `tune_cache_version()`
(never the reference's tag, so a port-tuned and a reference-tuned plan
never share a plan key), and the launches travel beside it: in the
`TuneCache`, and, beside a saved artifact, in a sidecar list of tune
entries (`sidecar_path`).

Results persist in a content-addressed `TuneCache`: the key digests the op
codec, the measuring device and backend, the launch table's version
(`tiles.HOPPER_KERNEL_TILE_VERSION`) and the search mode, exactly as the
reference's `TuneKey` does, so the same fields give the same digest in
both packages.  A port entry is marked `"kernels": "hopper"`; the two
packages refuse each other's entries, even in a shared directory.  Corrupt
or mismatched entries are misses, recorded with the rule they failed
(`analysis.rejections`), never trusted.

Measuring needs the card: `measure_device` and `measure_tile_us` raise on a
host without CUDA, and nothing here times a plain version instead.
`time_ms` is the port's one device timing: CUDA events around one call,
the L2 cache flushed before it and the host's launch time kept out.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.types import Op
from repro_torch.kernels import registry, tiles

TUNE_SCHEMA_VERSION = 1

#: default on-disk location, next to the plan cache's reports layout
DEFAULT_TUNE_DIR = Path("reports/tune")

#: a candidate must beat the default by this fraction to dethrone it —
#: keeps measurement noise from churning the cached choice run to run
TUNE_HYSTERESIS = 0.02

#: what a port tune entry's `tile` holds: a Hopper launch
TUNE_KERNELS = "hopper"


def tune_cache_version() -> str:
    """The tag a tuned compile folds into `PlanProvenance.tune`: the port's
    own (the reference's reads ``tune-v1.k1``); bumping either constant
    invalidates every tuned plan."""
    return (f"{TUNE_KERNELS}-tune-v{TUNE_SCHEMA_VERSION}"
            f".k{tiles.HOPPER_KERNEL_TILE_VERSION}")


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} needs CUDA, which this host does not have: the "
            f"autotuner times the port's kernels on the card and never "
            f"times their plain versions instead")


def measure_device() -> Tuple[str, str]:
    """(device_kind, backend) identity of the card actually measured;
    raises where there is no CUDA."""
    _require_cuda("measure_device")
    return torch.cuda.get_device_name(), "cuda"


# ----------------------------------------------------------- the timing

_FLUSH: Optional[torch.Tensor] = None
_SPIN_CYCLES_PER_MS: Optional[float] = None


def _spin_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms of device time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(cycles)                  # warm
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn: Callable[[], Any], reps: int = 10) -> float:
    """Median device time of one call of `fn` on the current CUDA device.
    One untimed call warms it.  Before each timed call a 128 MB write
    evicts the 50 MB L2 cache, then a spin kernel holds the stream for
    twice the host's time to enqueue the call (capped at 100 ms): the call
    and its end event are queued before the start event fires, so the
    events bracket the call's device work and not the host's launch
    overhead (allocations, ctypes, enqueue)."""
    global _FLUSH, _SPIN_CYCLES_PER_MS
    _require_cuda("time_ms")
    if _FLUSH is None:
        _FLUSH = torch.empty(32 * 1024 * 1024, device="cuda")
        _SPIN_CYCLES_PER_MS = _spin_cycles_per_ms()
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spin = int(_SPIN_CYCLES_PER_MS * min(100.0, 2 * host_ms + 0.2))
    times = []
    for _ in range(max(1, reps)):
        _FLUSH.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -------------------------------------------------------------- the key

@dataclasses.dataclass(frozen=True)
class TuneKey:
    """Everything a cached launch choice's validity depends on: the
    reference's fields, so equal fields give the reference's digest."""

    op_json: Tuple[Tuple[str, Any], ...]
    device: str
    backend: str
    kernel_version: int = tiles.HOPPER_KERNEL_TILE_VERSION
    schema_version: int = TUNE_SCHEMA_VERSION
    preserve_numerics: bool = True

    @staticmethod
    def for_op(op: Op, device: str, backend: str, *,
               preserve_numerics: bool = True) -> "TuneKey":
        return TuneKey(op_json=tuple(sorted(registry.op_to_json(op).items())),
                       device=device, backend=backend,
                       preserve_numerics=preserve_numerics)

    def _canonical(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["op_json"] = dict(self.op_json)
        return d

    @property
    def key(self) -> str:
        blob = json.dumps(self._canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def tune_entry(key: TuneKey, launch: tiles.Launch,
               measured: Sequence[Tuple[str, float]]) -> Dict[str, Any]:
    """A tune entry document: the tune cache's file, and an item of a
    tuned artifact's sidecar."""
    return {"schema_version": TUNE_SCHEMA_VERSION, "kernels": TUNE_KERNELS,
            "key": key._canonical(), "tile": tiles.launch_to_json(launch),
            "measured_us": [[label, round(us, 3)] for label, us in measured]}


def entry_op(doc: Dict[str, Any]) -> Op:
    return registry.op_from_json(dict(doc["key"]["op_json"]))


def entry_launch(doc: Dict[str, Any]) -> tiles.Launch:
    """The entry's launch, validated against its op's launch extents."""
    op = entry_op(doc)
    kind = registry.op_kind(op)
    return tiles.launch_spec(kind).validate(
        tiles.launch_from_json(kind, doc["tile"]),
        registry.launch_extents(op))


class TuneCache:
    """On-disk cache of measured launch choices — one JSON file per
    TuneKey digest.  `hits`/`misses` count lookups since construction."""

    def __init__(self, root: Path = DEFAULT_TUNE_DIR):
        self.root = Path(root)
        self.hits = 0
        self.misses = 0

    def path_for(self, key: TuneKey) -> Path:
        return self.root / f"{key.key}.json"

    def entry(self, key: TuneKey) -> Optional[Dict[str, Any]]:
        """The entry document stored for `key`, or None (a miss): a file
        that is corrupt, is not a Hopper entry, carries another key or an
        illegal launch is recorded with its rule and not trusted."""
        from repro_torch.analysis import rejections
        path = self.path_for(key)
        if path.exists():
            try:
                doc = json.loads(path.read_text())
                got = doc.get("key")
                if doc.get("kernels") != TUNE_KERNELS:
                    rejections.record(path.stem, "schema.malformed",
                                      f"not a Hopper launch entry "
                                      f"(kernels={doc.get('kernels')!r})")
                elif got == key._canonical():
                    entry_launch(doc)
                    self.hits += 1
                    return doc
                else:
                    want = key._canonical()
                    fields = sorted(set(want) | set(got or {})) \
                        if isinstance(got, dict) else []
                    stale = [f for f in fields
                             if (got or {}).get(f) != want.get(f)]
                    rejections.record(path.stem, "provenance.mismatch",
                                      f"stale tune key fields: {stale}")
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                rejections.record(path.stem, "tile.legality"
                                  if "launch" in str(e) else
                                  "schema.malformed", str(e))
        self.misses += 1
        return None

    def get(self, key: TuneKey) -> Optional[tiles.Launch]:
        doc = self.entry(key)
        return None if doc is None else entry_launch(doc)

    def put(self, key: TuneKey, launch: tiles.Launch,
            measured: Sequence[Tuple[str, float]]) -> Path:
        path = self.path_for(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(tune_entry(key, launch, measured),
                                   indent=1))
        return path

    def keys(self) -> List[str]:
        if not self.root.is_dir():
            return []
        return sorted(p.stem for p in self.root.glob("*.json"))


# ---------------------------------------------------------- measuring

@functools.lru_cache(maxsize=1)
def kernel_call(op: Op, seed: int = 0) -> Callable[[tiles.Launch], Any]:
    """The op's Hopper kernel on seeded fp32 operands drawn on the card,
    as a function of a launch: the call its lowering makes, with the
    operands (for a conv, the Winograd transforms of its input and filter)
    prepared once, outside anything timed.  The last op's operands stay
    cached, so timing its candidates draws them once."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention)
    from repro_torch.kernels.split_matmul.split_matmul import split_matmul
    from repro_torch.kernels.ssd_chunk.ops import _unpack_params
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_scan
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul, winograd_operands)

    _require_cuda("kernel_call")
    kind = registry.op_kind(op)
    if not registry.launch_extents(op):
        raise ValueError(f"{registry.op_label(op)} launches no kernel of the "
                         f"port (a direct conv): nothing to time")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, fan_in: int = 1) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device="cuda") \
            / fan_in ** 0.5

    if kind == "linear":
        x, w = draw(op.L, op.C_in), draw(op.C_in, op.C_out, fan_in=op.C_in)
        return lambda launch: split_matmul(x, w, 0, op.C_out, launch=launch)
    if kind == "conv":
        u, v = winograd_operands(
            draw(1, op.H_in, op.W_in, op.C_in),
            draw(3, 3, op.C_in, op.C_out, fan_in=9 * op.C_in))
        return lambda launch: hadamard_matmul(u, v, launch=launch)
    if kind == "attention":
        q = draw(op.H, op.hd)
        k, v = draw(op.S, op.KV, op.hd), draw(op.S, op.KV, op.hd)
        return lambda launch: decode_attention(q, k, v, op.S - 1,
                                               window=op.window,
                                               launch=launch)
    x = draw(1, op.T, op.H, op.hd)
    params = _unpack_params(
        draw(*registry.entry_for(op).weight_shape(op), fan_in=op.N), op)
    return lambda launch: ssd_chunk_scan(x, *params, launch=launch)


def measure_tile_us(op: Op, launch: Optional[tiles.Launch] = None, *,
                    reps: int = 2, seed: int = 0) -> float:
    """Median device time (us) of the op's Hopper kernel under one launch
    (None: the default), by `time_ms`: a warm-up call, then `reps` timed
    calls with the L2 flushed before each.  Raises without CUDA."""
    _require_cuda("measure_tile_us")
    call = kernel_call(op, seed)
    return time_ms(lambda: call(launch), reps=reps) * 1e3


# ------------------------------------------------------------ searching

def _tune(op: Op, candidates: Optional[List[tiles.Launch]], *,
          cache: Optional[TuneCache], device: str, backend: str,
          preserve_numerics: bool, reps: int, seed: int) -> Dict[str, Any]:
    """The tune entry of `op`: the cache's, or measured (and stored)."""
    if not device or not backend:
        mdev, mback = measure_device()
        device = device or mdev
        backend = backend or mback
    key = TuneKey.for_op(op, device, backend,
                         preserve_numerics=preserve_numerics)
    if cache is not None and candidates is None:
        hit = cache.entry(key)
        if hit is not None:
            return hit
    kind = registry.op_kind(op)
    spec = tiles.launch_spec(kind)
    extents = registry.launch_extents(op)
    default = spec.default()
    measured: List[Tuple[str, float]] = []
    best = default
    if extents:          # a direct conv launches no kernel: nothing to time
        if candidates is None:
            candidates = spec.configs(extents,
                                      preserve_numerics=preserve_numerics)
        best_us = default_us = None
        for cfg in candidates:
            us = measure_tile_us(op, cfg, reps=reps, seed=seed)
            measured.append((cfg.label(), us))
            if cfg == default:
                default_us = us
            if best_us is None or us < best_us:
                best, best_us = cfg, us
        if default_us is None:                  # default outside the grid
            default_us = measure_tile_us(op, default, reps=reps, seed=seed)
            measured.append((default.label(), default_us))
        # hysteresis: stay on the default unless the winner clearly beats it
        if best != default and best_us > default_us * (1.0 - TUNE_HYSTERESIS):
            best = default
    if cache is not None:
        cache.put(key, best, measured)
    return tune_entry(key, best, measured)


def autotune(op: Op, candidates: Optional[List[tiles.Launch]] = None, *,
             cache: Optional[TuneCache] = None, device: str = "",
             backend: str = "", preserve_numerics: bool = True,
             reps: int = 2, seed: int = 0) -> tiles.Launch:
    """Measured search over an op's legal launch grid.

    Returns the winning `Launch` (the default when nothing beats it by
    `TUNE_HYSTERESIS`).  With a `cache`, a prior choice for the same (op,
    device, backend, launch-table version, search mode) is returned
    without measuring anything; a cold search stores its result with the
    per-candidate times."""
    return entry_launch(_tune(op, candidates, cache=cache, device=device,
                              backend=backend,
                              preserve_numerics=preserve_numerics, reps=reps,
                              seed=seed))


def annotate_plan_tiles(plan, *, cache: Optional[TuneCache] = None,
                        device: str = "", backend: str = "",
                        preserve_numerics: bool = True,
                        reps: int = 2) -> List[Dict[str, Any]]:
    """Tune every unique op of a plan's schedule once; returns their tune
    entries in schedule order (a tuned artifact's sidecar).

    The tune pass `compile(..., tune=True)` runs on a plan-cache miss
    (`runtime.cache.plan_graph_cached`'s `annotate` hook) and, through a
    warm tune cache, on a hit.  Unlike the reference's it leaves the plan
    untouched: no decision gains a `tile` key, and the plan document a
    tuned compile stores differs from the untuned one only in its
    provenance `tune` tag."""
    from repro_torch.runtime.plan import decision_from_json
    if not device or not backend:
        mdev, mback = measure_device()
        device = device or mdev
        backend = backend or mback
    entries: List[Dict[str, Any]] = []
    seen = set()
    for entry in plan.schedule:
        dec_json = entry.get("decision")
        if not dec_json:
            continue
        op = decision_from_json(dec_json).op
        if op in seen:
            continue
        seen.add(op)
        entries.append(_tune(op, None, cache=cache, device=device,
                             backend=backend,
                             preserve_numerics=preserve_numerics, reps=reps,
                             seed=0))
    return entries


# --------------------------------------------------- tuned artifacts

def launches_from_entries(entries: Sequence[Dict[str, Any]]
                          ) -> Dict[Op, tiles.Launch]:
    """op -> tuned launch, from tune entries (what `PlanExecutor` takes)."""
    return {entry_op(doc): entry_launch(doc) for doc in entries}


def sidecar_path(artifact: Path) -> Path:
    """Where a tuned artifact's Hopper launches live: beside it, as
    `<stem>.hopper_tiles.json` (a JSON list of tune entries)."""
    artifact = Path(artifact)
    return artifact.with_name(f"{artifact.stem}.hopper_tiles.json")
