"""Static plan/IR verifier of the port: prove co-execution invariants
without running.

The port's copy of the reference verifier (`repro.analysis.verify`): the
same rules, rule ids and messages over the port's own graph IR, registry
and plan codec.  `verify_plan` takes a plan (a `CoexecPlan` or its raw
JSON document) and returns structured `Diagnostic`s, so a plan document
the reference would refuse is refused here too, before its first
execution: `CoexecPlan.from_json` and `CompiledNetwork.from_json` verify
by default and raise `VerificationError` on error diagnostics.

Everything here is pure Python over `graph.ir`, `kernels.registry` and
`runtime.plan`, and executes nothing: `python -m repro_torch verify`
never imports jax (subprocess-tested).  `verify_portfolio` checks plan
portfolios (each entry's artifact and its bucket tag), and
`verify_tune_entry` tune-cache entries: the reference's, whose `tile` is
a TPU `TileConfig`, and the port's (`"kernels": "hopper"`), whose `tile`
is a Hopper launch checked against the port's launch table; a tuned
artifact's sidecar is a list of the port's.  Bench reports come with the
module that produces them; until then `verify_path` names them as
unsupported (`artifact.format`).

Checks, by rule family:

  * ``schema.*``       — document shape, schema versions, and the
    byte-compat discipline: keys that the codecs omit at their defaults
    (``axis`` at "channel", ``tile`` at the default blocking, op ``mode``
    at the kind default, empty provenance calibration/bucket/tune tags,
    ``id`` keys on unit-chain schedules) must not be present.
  * ``axis.*``         — split legality re-derived from the registry
    (`validate_axis_split`) plus share accounting (channel shares sum to
    C_out, typed-axis shares sum to the axis size).
  * ``tile.*``         — tile configs re-validated against the registry
    `TileSpec` (alignment, padded extents, VMEM budget).
  * ``graph.*``        — embedded graph validity, schedule/graph
    agreement, and recomputation of the content-addressed fingerprint
    against `provenance.network_fingerprint`.
  * ``segment.*``      — the embedded segment partition must cover the
    schedule, equal the re-derived `Graph.segments` partition, and
    independently satisfy convexity, the one-gather-per-fused-segment
    rule, and gather-elision soundness (sole-consumer rule).
  * ``provenance.*``   — the plan-cache digest recomputed from the
    embedded provenance fields must equal the expected key (the cache
    filename).
  * ``resource.*``     — info-severity static resource accounting:
    per-device peak activation liveness from a refcounted topological
    walk, sync-point count, and boundary traffic bytes.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.graph.ir import (SEGMENT_EXCLUSIVE, SEGMENT_FUSED,
                                  SEGMENT_POOL, Graph, Node, Segment)
from repro_torch.kernels import registry
from repro_torch.runtime.plan import PLAN_SCHEMA_VERSION, PlanProvenance

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"

#: rule id -> one-line description (the reference's rules, id for id)
RULES: Dict[str, str] = {
    "schema.version": "plan/artifact schema version is supported and "
                      "consistent with the embedded provenance",
    "schema.malformed": "document shape: required keys, entry arity, "
                        "op/decision field types parse",
    "schema.default-key": "omitted-when-default byte-compat: no key "
                          "serialized at its default value",
    "axis.legality": "partition axis legal for the op "
                     "(registry.validate_axis_split)",
    "axis.shares": "split shares account for the full axis "
                   "(c_cpu + c_gpu == axis size; exclusive = one side)",
    "tile.legality": "tile config legal for the op "
                     "(alignment, padded extents, VMEM budget)",
    "graph.invalid": "embedded graph validates (ids, arity, acyclicity, "
                     "single output)",
    "graph.schedule": "schedule entries agree with the graph "
                      "(ids, kinds, ops, pool bytes, topological order)",
    "graph.fingerprint": "recomputed graph fingerprint equals "
                         "provenance.network_fingerprint",
    "segment.cover": "embedded segments cover the schedule exactly, "
                     "in topological order",
    "segment.mismatch": "embedded segments equal the re-derived "
                        "Graph.segments partition",
    "segment.convexity": "every non-final node of a fused segment has all "
                         "consumers inside the segment",
    "segment.gather": "fused segments contain only co-executed or add "
                      "nodes (one gather, at the final node)",
    "segment.elision": "interior co-executed nodes satisfy the "
                       "sole-consumer gather-elision predicate",
    "provenance.digest": "recomputed provenance digest equals the "
                         "expected cache key",
    "provenance.mismatch": "cached plan's embedded provenance equals the "
                           "requested one (cache-layer rule)",
    "artifact.format": "artifact format/version markers are supported",
    "artifact.checksum": "recomputed artifact checksum matches",
    "portfolio.bucket": "portfolio entry bucket tag matches its plan's "
                        "provenance bucket",
    "bench.schema": "bench report carries the suite/metrics schema",
    "bench.metric": "bench metrics are finite non-negative numbers",
    "resource.accounting": "static resource accounting (info): peak "
                           "liveness, sync points, boundary traffic",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding: severity + rule id + location + fix hint."""

    severity: str                  # error | warning | info
    rule: str                      # e.g. "axis.legality"
    node: str                      # node id / entry index ("" = plan-level)
    message: str
    hint: str = ""

    def __str__(self) -> str:
        loc = f" [{self.node}]" if self.node else ""
        tail = f" (hint: {self.hint})" if self.hint else ""
        return f"{self.severity}: {self.rule}{loc}: {self.message}{tail}"


def errors(diags: List[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == SEV_ERROR]


class VerificationError(ValueError):
    """Raised by strict loads on error-severity diagnostics; carries the
    full diagnostic list so cache layers can log *which* rule failed."""

    def __init__(self, context: str, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        errs = errors(self.diagnostics)
        head = "; ".join(str(d) for d in errs[:3])
        more = f" (+{len(errs) - 3} more)" if len(errs) > 3 else ""
        super().__init__(f"{context} failed static verification: "
                         f"{head}{more}")


def raise_on_error(diags: List[Diagnostic], context: str) -> None:
    if errors(diags):
        raise VerificationError(context, diags)


# -------------------------------------------------------------- the verifier

def _err(rule: str, node: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(SEV_ERROR, rule, node, message, hint)


def verify_plan(plan, *, graph: Optional[Graph] = None,
                expect_key: Optional[str] = None,
                stats: bool = True) -> List[Diagnostic]:
    """Statically verify one plan (a `CoexecPlan` or its raw JSON doc).

    Never raises on a bad plan — every violation becomes a `Diagnostic`
    (malformed documents yield ``schema.malformed`` errors rather than
    exceptions).  `expect_key` is the provenance digest the plan is filed
    under (the cache filename stem); when given, the digest is recomputed
    from the embedded fields and compared.  `graph` overrides the graph
    the structural checks run against (default: the embedded/derived
    one).  ``stats=False`` skips the info-severity resource accounting.
    """
    if hasattr(plan, "to_json") and hasattr(plan, "provenance"):
        doc = plan.to_json()
    elif isinstance(plan, dict):
        doc = plan
    else:
        return [_err("schema.malformed", "",
                     f"not a plan document: {type(plan).__name__}")]

    diags: List[Diagnostic] = []
    schedule = doc.get("schedule")
    if not isinstance(schedule, list) or "provenance" not in doc:
        diags.append(_err("schema.malformed", "",
                          "plan document needs 'provenance' and a "
                          "'schedule' list"))
        return diags

    prov = _check_provenance(doc, diags)
    entries = _check_schedule(doc, schedule, diags)
    g = graph if graph is not None else _plan_graph(doc, entries, diags)

    if g is not None:
        _check_graph(doc, g, prov, entries, diags)
        coexec = frozenset(e.node for e in entries if e.coexec)
        _check_segments(doc, g, coexec, entries, diags)
        if stats and not errors(diags):
            st = _stats_from(g, entries, coexec)
            diags.append(Diagnostic(SEV_INFO, "resource.accounting", "",
                                    st.summary()))
    if expect_key is not None and prov is not None and prov.key != expect_key:
        diags.append(_err(
            "provenance.digest", "",
            f"recomputed provenance digest {prov.key} != expected "
            f"{expect_key}",
            "the plan was edited after it was keyed, or filed under the "
            "wrong name; recompile instead of patching the JSON"))
    return diags


# ------------------------------------------------------------- provenance

def _check_provenance(doc: Dict[str, Any],
                      diags: List[Diagnostic]) -> Optional[PlanProvenance]:
    raw = doc.get("provenance")
    if not isinstance(raw, dict):
        diags.append(_err("schema.malformed", "",
                          "'provenance' must be an object"))
        return None
    for field in ("calibration", "bucket", "tune"):
        if field in raw and not raw[field]:
            diags.append(_err(
                "schema.default-key", "",
                f"provenance {field!r} serialized at its empty default",
                "PlanProvenance._canonical omits empty tags so legacy "
                "digests stay warm"))
    try:
        prov = PlanProvenance.from_json(
            {k: v for k, v in raw.items()})
    except TypeError as e:
        diags.append(_err("schema.malformed", "",
                          f"provenance does not parse: {e}"))
        return None
    if doc.get("schema_version") != prov.schema_version:
        diags.append(_err(
            "schema.version", "",
            f"document schema_version {doc.get('schema_version')!r} != "
            f"provenance schema_version {prov.schema_version!r}"))
    if prov.schema_version != PLAN_SCHEMA_VERSION:
        diags.append(_err(
            "schema.version", "",
            f"unsupported plan schema version {prov.schema_version!r} "
            f"(supported: {PLAN_SCHEMA_VERSION})"))
    return prov


# --------------------------------------------------------------- schedule

@dataclasses.dataclass
class _Entry:
    """One parsed schedule entry (raw dict + derived planning facts)."""

    index: int
    node: str                       # node id ("n{i}" when entries carry none)
    unit: str
    raw: Dict[str, Any]
    op: Any = None                  # parsed Op (None for pool/add/bad ops)
    coexec: bool = False            # channel-split co-executed (fusable)
    pool_bytes: int = 0


def _check_schedule(doc: Dict[str, Any], schedule: List[Any],
                    diags: List[Diagnostic]) -> List[_Entry]:
    has_graph = doc.get("graph") is not None
    entries: List[_Entry] = []
    for i, e in enumerate(schedule):
        if not isinstance(e, dict) or "unit" not in e:
            diags.append(_err("schema.malformed", f"#{i}",
                              "schedule entry needs a 'unit' key"))
            continue
        nid = e.get("id", f"n{i}")
        if "id" in e and not has_graph:
            diags.append(_err(
                "schema.default-key", nid,
                "unit-chain schedules omit 'id' keys (canonical n{i} "
                "positions)", "see runtime.plan.build_graph_schedule"))
        if "id" not in e and has_graph:
            diags.append(_err("schema.malformed", f"#{i}",
                              "graph plans carry explicit 'id' keys"))
        ent = _Entry(index=i, node=nid, unit=e["unit"], raw=e)
        entries.append(ent)
        if e["unit"] == "pool":
            if not isinstance(e.get("bytes"), int) or e["bytes"] <= 0:
                diags.append(_err("schema.malformed", nid,
                                  "pool entry needs a positive integer "
                                  "'bytes'"))
            else:
                ent.pool_bytes = e["bytes"]
            continue
        if e["unit"] == "add":
            continue
        if e["unit"] not in registry.kinds():
            diags.append(_err("schema.malformed", nid,
                              f"unknown unit kind {e['unit']!r} "
                              f"(known: {registry.kinds()})"))
            continue
        if "decision" in e:
            _check_decision(ent, e["decision"], diags)
        elif "op" in e:                      # legacy opaque exclusive node
            ent.op = _parse_op(e["unit"], e["op"], nid, diags)
        else:
            diags.append(_err("schema.malformed", nid,
                              "op entry needs a 'decision' (or legacy "
                              "'op' + 'pred_us')"))
    return entries


def _parse_op(unit: str, op_json: Any, nid: str,
              diags: List[Diagnostic]):
    if not isinstance(op_json, dict) or "kind" not in op_json:
        diags.append(_err("schema.malformed", nid,
                          "op JSON must be an object with a 'kind'"))
        return None
    if op_json["kind"] != unit:
        diags.append(_err("schema.malformed", nid,
                          f"entry unit {unit!r} != op kind "
                          f"{op_json['kind']!r}"))
        return None
    if op_json.get("mode") == registry.default_mode(unit):
        diags.append(_err(
            "schema.default-key", nid,
            f"op 'mode' serialized at its default "
            f"{registry.default_mode(unit)!r}",
            "registry.op_to_json omits the default mode"))
    try:
        return registry.op_from_json(op_json)
    except (ValueError, KeyError, TypeError) as e:
        diags.append(_err("schema.malformed", nid,
                          f"op does not parse: {e}"))
        return None


def _check_decision(ent: _Entry, d: Any, diags: List[Diagnostic]) -> None:
    nid = ent.node
    if not isinstance(d, dict) or "op" not in d:
        diags.append(_err("schema.malformed", nid,
                          "decision must be an object with an 'op'"))
        return
    op = _parse_op(ent.unit, d["op"], nid, diags)
    ent.op = op
    c_cpu, c_gpu = d.get("c_cpu"), d.get("c_gpu")
    if not (isinstance(c_cpu, int) and isinstance(c_gpu, int)
            and c_cpu >= 0 and c_gpu >= 0):
        diags.append(_err("schema.malformed", nid,
                          f"decision shares must be non-negative integers "
                          f"(c_cpu={c_cpu!r}, c_gpu={c_gpu!r})"))
        return
    for f in ("pred_cpu_us", "pred_gpu_us", "pred_total_us"):
        if not isinstance(d.get(f), (int, float)):
            diags.append(_err("schema.malformed", nid,
                              f"decision needs numeric {f!r}"))
    axis = d.get("axis", "channel")
    if d.get("axis") == "channel":
        diags.append(_err(
            "schema.default-key", nid,
            "'axis' serialized at its default \"channel\"",
            "decision_to_json omits the channel axis so pre-axis plan "
            "JSON stays byte-identical"))
    if op is None:
        return
    entry = registry.get(ent.unit)
    if axis == "channel":
        if not entry.splittable:
            diags.append(_err(
                "axis.legality", nid,
                f"kind {ent.unit!r} is not channel-splittable",
                f"use a typed axis "
                f"({[a.axis for a in entry.axes]}) or axis 'none'"))
        elif c_cpu + c_gpu != op.C_out:
            diags.append(_err(
                "axis.shares", nid,
                f"channel shares {c_cpu}+{c_gpu} != C_out {op.C_out}"))
        ent.coexec = c_cpu > 0 and c_gpu > 0
    elif axis == "none":
        if (c_cpu > 0) == (c_gpu > 0):
            diags.append(_err(
                "axis.shares", nid,
                f"axis 'none' is an exclusive placement: exactly one "
                f"side carries the op (got c_cpu={c_cpu}, c_gpu={c_gpu})"))
    else:
        try:
            spec = registry.validate_axis_split(op, axis, c_gpu)
        except (ValueError, KeyError) as e:
            diags.append(_err("axis.legality", nid, str(e)))
            spec = None
        if spec is not None and c_cpu + c_gpu != spec.size(op):
            diags.append(_err(
                "axis.shares", nid,
                f"{axis} shares {c_cpu}+{c_gpu} != axis size "
                f"{spec.size(op)}"))
    if "tile" in d:
        _check_tile(ent, d["tile"], diags)


def _check_tile(ent: _Entry, tile_json: Any,
                diags: List[Diagnostic]) -> None:
    nid = ent.node
    if not tile_json:
        diags.append(_err("schema.default-key", nid,
                          "'tile' serialized at its empty default",
                          "decision_to_json omits absent tiles"))
        return
    try:
        tile = registry.tile_from_json(ent.unit, tile_json)
        resolved = registry.resolve_tile(ent.op, tile) \
            if ent.op is not None else tile
    except (ValueError, KeyError, TypeError) as e:
        diags.append(_err("tile.legality", nid, str(e),
                          "clamp via registry.TileSpec.clamp_tile "
                          "instead of shipping an illegal tile"))
        return
    if ent.op is not None and \
            resolved == registry.default_tile(ent.op):
        diags.append(_err(
            "schema.default-key", nid,
            f"'tile' {resolved.label()} equals the default blocking",
            "annotate_plan_tiles attaches tiles only when the winner "
            "differs from the default"))


def _structural(op) -> Dict[str, Any]:
    """Op JSON modulo execution mode: the decision op carries the chosen
    kernel mode while the graph node holds the structural identity."""
    d = registry.op_to_json(op)
    d.pop("mode", None)
    return d


# ------------------------------------------------------------------- graph

def _plan_graph(doc: Dict[str, Any], entries: List[_Entry],
                diags: List[Diagnostic]) -> Optional[Graph]:
    if doc.get("graph") is not None:
        try:
            return Graph.from_json(doc["graph"])
        except (ValueError, KeyError, TypeError) as e:
            diags.append(_err("graph.invalid", "",
                              f"embedded graph does not validate: {e}"))
            return None
    # unit-chain plans: reconstruct the linear chain from the schedule
    nodes: List[Node] = []
    prev: Tuple[str, ...] = ()
    for ent in entries:
        try:
            if ent.unit == "pool":
                nodes.append(Node(id=ent.node, kind="pool",
                                  pool_bytes=ent.pool_bytes, inputs=prev))
            elif ent.op is not None:
                nodes.append(Node(id=ent.node, kind=ent.unit, op=ent.op,
                                  inputs=prev))
            else:                  # bad op already diagnosed: no graph
                return None
        except ValueError as e:
            diags.append(_err("graph.invalid", ent.node, str(e)))
            return None
        prev = (ent.node,)
    if not nodes:
        diags.append(_err("schema.malformed", "", "empty schedule"))
        return None
    return Graph(nodes)


def _check_graph(doc: Dict[str, Any], g: Graph,
                 prov: Optional[PlanProvenance], entries: List[_Entry],
                 diags: List[Diagnostic]) -> None:
    if doc.get("graph") is not None and g.is_unit_chain():
        diags.append(_err(
            "schema.default-key", "",
            "graph embedded for a unit chain",
            "unit-chain plans omit 'graph' (and 'id' keys) so the "
            "serialized format stays bit-identical to the pre-IR era"))
    ids = [e.node for e in entries]
    graph_ids = [n.id for n in g.nodes]
    if ids != graph_ids:
        diags.append(_err(
            "graph.schedule", "",
            f"schedule ids {ids[:6]}... do not match the graph's "
            f"topological order {graph_ids[:6]}..."))
        return
    for ent in entries:
        n = g.node(ent.node)
        if n.kind != ent.unit:
            diags.append(_err("graph.schedule", ent.node,
                              f"schedule unit {ent.unit!r} != graph node "
                              f"kind {n.kind!r}"))
        elif ent.unit == "pool" and n.pool_bytes != ent.pool_bytes:
            diags.append(_err("graph.schedule", ent.node,
                              f"pool bytes {ent.pool_bytes} != graph "
                              f"node's {n.pool_bytes}"))
        elif ent.op is not None and n.op is not None and \
                _structural(ent.op) != _structural(n.op):
            diags.append(_err(
                "graph.schedule", ent.node,
                f"schedule op {registry.op_label(ent.op)} != graph "
                f"node op {registry.op_label(n.op)}"))
    if prov is not None:
        fp = g.fingerprint()
        if fp != prov.network_fingerprint:
            diags.append(_err(
                "graph.fingerprint", "",
                f"recomputed graph fingerprint {fp} != provenance "
                f"network_fingerprint {prov.network_fingerprint}",
                "the schedule/graph was edited after planning; recompile"))


# ---------------------------------------------------------------- segments

def _check_segments(doc: Dict[str, Any], g: Graph, coexec,
                    entries: List[_Entry],
                    diags: List[Diagnostic]) -> None:
    derived = g.segments(coexec)
    parts: List[Segment] = derived
    if doc.get("segments") is not None:
        embedded = []
        for i, s in enumerate(doc["segments"]):
            try:
                embedded.append(Segment(kind=s["kind"],
                                        node_ids=tuple(s["nodes"])))
            except (ValueError, KeyError, TypeError) as e:
                diags.append(_err("schema.malformed", f"segment#{i}",
                                  f"segment does not parse: {e}"))
                return
        covered = [nid for s in embedded for nid in s.node_ids]
        if covered != [e.node for e in entries]:
            diags.append(_err(
                "segment.cover", "",
                "embedded segments do not cover the schedule exactly in "
                "topological order",
                "segment_partition() would silently re-derive; committed "
                "artifacts must carry consistent metadata"))
        elif embedded != derived:
            diags.append(_err(
                "segment.mismatch", "",
                f"embedded segments ({len(embedded)}) != re-derived "
                f"Graph.segments partition ({len(derived)})",
                "planners embed exactly graph.segments(coexec); the "
                "metadata went stale"))
        parts = embedded
    elided = g.elided(coexec)
    for k, seg in enumerate(parts):
        tag = f"segment#{k}"
        known = [nid for nid in seg.node_ids if nid in g._by_id]
        if len(known) != len(seg.node_ids):
            continue                        # cover diagnosis already covers
        if seg.kind == SEGMENT_POOL:
            if any(g.node(nid).kind != "pool" for nid in seg.node_ids):
                diags.append(_err("segment.gather", tag,
                                  "pool segment holds a non-pool node"))
            continue
        if seg.kind == SEGMENT_EXCLUSIVE:
            if any(nid in coexec for nid in seg.node_ids):
                diags.append(_err(
                    "segment.gather", tag,
                    "co-executed node in an exclusive segment",
                    "channel-split nodes fuse; typed-axis splits are "
                    "exclusive singletons"))
            continue
        assert seg.kind == SEGMENT_FUSED
        for nid in seg.node_ids:
            n = g.node(nid)
            if nid not in coexec and n.kind != "add":
                diags.append(_err(
                    "segment.gather", tag,
                    f"node {nid!r} ({n.kind}) is neither co-executed nor "
                    f"an add join: fusing it would force a sync inside "
                    f"one jitted program"))
        inside = set(seg.node_ids)
        for nid in seg.node_ids[:-1]:
            leaked = [c for c in g.consumers(nid) if c not in inside]
            if leaked:
                diags.append(_err(
                    "segment.convexity", tag,
                    f"interior node {nid!r} publishes to {leaked} outside "
                    f"the segment (a fused run has a single gathered "
                    f"output)"))
            elif nid in coexec and len(g.consumers(nid)) == 1:
                # interior split outputs stay group-local: either the
                # sole consumer is an add (joined split-wise inside the
                # fused program) or the elision predicate holds
                u = g.node(g.consumers(nid)[0])
                if u.kind != "add" and nid not in elided:
                    diags.append(_err(
                        "segment.elision", tag,
                        f"interior node {nid!r} fails the sole-consumer "
                        f"gather-elision predicate",
                        "its consumer is not a compatible co-executed "
                        "op, so its split output must be gathered — the "
                        "segment must cut here"))


# ------------------------------------------------------ resource accounting

@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Static resource accounting of one plan (fp32 activation bytes)."""

    nodes: int
    coexec_nodes: int
    segments: int
    fused_segments: int
    sync_points: int                # gathers (materialization points)
    boundary_bytes: int             # bytes crossing the CPU/GPU boundary
    peak_live_bytes: int            # peak total activation liveness
    peak_fast_bytes: int            # GPU-analogue group's share of the peak
    peak_slow_bytes: int            # CPU-analogue group's share of the peak

    def summary(self) -> str:
        return (f"peak live {self.peak_live_bytes / 1e6:.2f} MB "
                f"(fast {self.peak_fast_bytes / 1e6:.2f} / slow "
                f"{self.peak_slow_bytes / 1e6:.2f}), "
                f"{self.sync_points} sync points, "
                f"{self.boundary_bytes / 1e6:.2f} MB boundary traffic, "
                f"{self.segments} segments ({self.fused_segments} fused), "
                f"{self.coexec_nodes}/{self.nodes} nodes co-executed")


def plan_stats(plan) -> PlanStats:
    """Static resource accounting for a verifiable plan (raises ValueError
    when the plan is too malformed to account — run `verify_plan` first)."""
    doc = plan.to_json() if hasattr(plan, "to_json") else plan
    diags: List[Diagnostic] = []
    schedule = doc.get("schedule")
    if not isinstance(schedule, list):
        raise ValueError("plan document has no schedule")
    entries = _check_schedule(doc, schedule, diags)
    g = _plan_graph(doc, entries, diags)
    if g is None or errors(diags):
        raise VerificationError("plan_stats", diags)
    coexec = frozenset(e.node for e in entries if e.coexec)
    return _stats_from(g, entries, coexec)


def _fast_fraction(ent: _Entry) -> float:
    """The GPU-analogue group's share of a node's output activation."""
    d = ent.raw.get("decision")
    if d is None:
        return 1.0                          # pool/add/opaque: GPU side
    c_cpu, c_gpu = int(d.get("c_cpu", 0)), int(d.get("c_gpu", 0))
    total = c_cpu + c_gpu
    if total <= 0:
        return 1.0
    if d.get("axis", "channel") == "none":
        return 1.0 if c_gpu else 0.0        # exclusive placement marker
    return c_gpu / total


def _stats_from(g: Graph, entries: List[_Entry], coexec) -> PlanStats:
    parts = g.segments(coexec)
    mat = g.materialization_points(coexec)

    def nbytes(nid: str) -> int:
        n = 4
        for dim in g.output_shape(nid):
            n *= int(dim)
        return n

    frac = {e.node: _fast_fraction(e) for e in entries}
    refs = {n.id: max(1, len(g.consumers(n.id))) for n in g.nodes}
    live: Dict[str, int] = {}
    peak = peak_fast = peak_slow = 0
    for n in g.nodes:
        live[n.id] = nbytes(n.id)
        total = sum(live.values())
        fast = sum(int(b * frac.get(nid, 1.0)) for nid, b in live.items())
        peak = max(peak, total)
        peak_fast = max(peak_fast, fast)
        peak_slow = max(peak_slow, total - fast)
        for src in n.inputs:
            refs[src] -= 1
            if refs[src] == 0:
                del live[src]
    return PlanStats(
        nodes=len(g),
        coexec_nodes=len(coexec),
        segments=len(parts),
        fused_segments=sum(1 for s in parts if s.kind == SEGMENT_FUSED),
        sync_points=len(mat),
        boundary_bytes=sum(nbytes(nid) for nid in mat),
        peak_live_bytes=peak,
        peak_fast_bytes=peak_fast,
        peak_slow_bytes=peak_slow)


# ------------------------------------------------------- artifacts on disk

def verify_artifact(doc: Dict[str, Any], *, stats: bool = True,
                    plan: bool = True) -> List[Diagnostic]:
    """Verify a `repro.compiled_network` artifact document.  ``plan=False``
    checks only the artifact's own format, version and checksum (what a
    load with ``verify=False`` still checks)."""
    # imported here: api -> runtime.plan -> analysis would otherwise cycle
    from repro_torch.api import (ARTIFACT_FORMAT, ARTIFACT_VERSION,
                                 _artifact_checksum)
    diags: List[Diagnostic] = []
    if doc.get("format") != ARTIFACT_FORMAT:
        diags.append(_err("artifact.format", "",
                          f"not a {ARTIFACT_FORMAT} artifact "
                          f"(format={doc.get('format')!r})"))
        return diags
    if doc.get("version") != ARTIFACT_VERSION:
        diags.append(_err("artifact.format", "",
                          f"unsupported artifact version "
                          f"{doc.get('version')!r}"))
    if doc.get("checksum") != _artifact_checksum(doc):
        diags.append(_err("artifact.checksum", "",
                          "recomputed artifact checksum does not match",
                          "the file was modified after it was saved"))
    if not plan:
        return diags
    body = doc.get("plan")
    if isinstance(body, dict):
        diags.extend(verify_plan(body, stats=stats))
    else:
        diags.append(_err("schema.malformed", "",
                          "artifact carries no plan document"))
    return diags


def verify_portfolio(doc: Dict[str, Any], *, stats: bool = False,
                     plan: bool = True) -> List[Diagnostic]:
    """Verify a `repro.plan_portfolio` document: its format, version and
    checksum, every entry's artifact (tagged with the entry's bucket), and
    that each entry's bucket tag is its plan's provenance bucket
    (`portfolio.bucket`).  ``plan=False`` checks only the formats, versions
    and checksums of the document and its entries (what a load with
    ``verify=False`` still checks)."""
    from repro_torch.api import (PORTFOLIO_FORMAT, PORTFOLIO_VERSION,
                                 _portfolio_checksum)
    diags: List[Diagnostic] = []
    if doc.get("format") != PORTFOLIO_FORMAT:
        diags.append(_err("artifact.format", "",
                          f"not a {PORTFOLIO_FORMAT} artifact "
                          f"(format={doc.get('format')!r})"))
        return diags
    if doc.get("version") != PORTFOLIO_VERSION:
        diags.append(_err("artifact.format", "",
                          f"unsupported portfolio version "
                          f"{doc.get('version')!r}"))
    if doc.get("checksum") != _portfolio_checksum(doc):
        diags.append(_err("artifact.checksum", "",
                          "recomputed portfolio checksum does not match",
                          "the file was modified after it was saved"))
    for e in doc.get("entries", []):
        tag = f"b{e.get('batch')}s{e.get('seq')}"
        sub = verify_artifact(e.get("artifact", {}), stats=stats, plan=plan)
        diags.extend(dataclasses.replace(
            d, node=f"{tag}/{d.node}" if d.node else tag) for d in sub)
        if not plan:
            continue
        prov = (e.get("artifact", {}).get("plan", {}) or {}) \
            .get("provenance", {})
        if isinstance(prov, dict) and prov.get("bucket", "") != tag:
            diags.append(_err(
                "portfolio.bucket", tag,
                f"entry bucket tag {tag!r} != plan provenance bucket "
                f"{prov.get('bucket', '')!r}"))
    return diags


def verify_tune_entry(doc: Dict[str, Any], *,
                      expect_key: Optional[str] = None) -> List[Diagnostic]:
    """Verify one tune entry (launch or tile legality + digest), with the
    reference's rule ids: a reference entry's TPU tile against the
    registry's `TileSpec`, a port entry's Hopper launch
    (`"kernels": "hopper"`) against `kernels.tiles`."""
    from repro_torch.kernels import tiles
    from repro_torch.runtime.autotune import (TUNE_KERNELS,
                                              TUNE_SCHEMA_VERSION, TuneKey)
    diags: List[Diagnostic] = []
    key, tile = doc.get("key"), doc.get("tile")
    if not isinstance(key, dict) or not isinstance(tile, dict):
        diags.append(_err("schema.malformed", "",
                          "tune entry needs 'key' and 'tile' objects"))
        return diags
    kernels = doc.get("kernels")
    if kernels not in (None, TUNE_KERNELS):
        diags.append(_err("schema.malformed", "",
                          f"unknown tune entry kernels {kernels!r}"))
        return diags
    if doc.get("schema_version") != TUNE_SCHEMA_VERSION:
        diags.append(_err("schema.version", "",
                          f"unsupported tune schema version "
                          f"{doc.get('schema_version')!r}"))
    op_json = key.get("op_json")
    try:
        op = registry.op_from_json(dict(op_json))
        kind = registry.op_kind(op)
        if kernels == TUNE_KERNELS:
            tiles.launch_spec(kind).validate(
                tiles.launch_from_json(kind, tile),
                registry.launch_extents(op))
        else:
            registry.resolve_tile(op, registry.tile_from_json(kind, tile))
    except (ValueError, KeyError, TypeError) as e:
        diags.append(_err("tile.legality", "",
                          f"cached tile does not validate: {e}"))
        return diags
    if expect_key is not None:
        try:
            tk = TuneKey(op_json=tuple(sorted(op_json.items())),
                         device=key["device"], backend=key["backend"],
                         kernel_version=key["kernel_version"],
                         schema_version=key["schema_version"],
                         preserve_numerics=key["preserve_numerics"])
        except (KeyError, TypeError) as e:
            diags.append(_err("schema.malformed", "",
                              f"tune key does not parse: {e}"))
            return diags
        if tk.key != expect_key:
            diags.append(_err("provenance.digest", "",
                              f"recomputed tune digest {tk.key} != "
                              f"expected {expect_key}"))
    return diags


def _unsupported(kind: str, path: Path) -> List[Diagnostic]:
    """A document the reference verifies but the port produces no module
    for yet (bench report)."""
    return [_err("artifact.format", "",
                 f"{path}: {kind} documents are not verified by the port "
                 f"yet (they come with the module that produces them)")]


def _sidecar_diags(path: Path, doc: Dict[str, Any]) -> List[Diagnostic]:
    """An artifact the port tuned is verified with its sidecar of tune
    entries, which must be beside it."""
    from repro_torch.runtime.autotune import sidecar_path, tune_cache_version
    tag = ((doc.get("plan") or {}).get("provenance") or {}).get("tune")
    if tag != tune_cache_version():
        return []
    side = sidecar_path(path)
    if not side.exists():
        return [_err("artifact.format", "",
                     f"tuned for the port's Hopper kernels ({tag}), but its "
                     f"sidecar {side} is missing")]
    kind, diags = verify_path(side)
    if kind != "tune":
        return [_err("artifact.format", "",
                     f"{side} is not a list of tune entries")]
    return diags


def verify_path(path: Path, *,
                stats: bool = False) -> Tuple[str, List[Diagnostic]]:
    """Verify one JSON file on disk, dispatching on its document shape.

    Returns ``(kind, diagnostics)`` where kind is one of "plan",
    "artifact", "portfolio", "tune", "bench", or "unknown".  Plan and tune
    cache files named by a 32-hex digest get their digest recomputed
    against the filename (`provenance.digest`).  A list of tune entries (a
    tuned artifact's sidecar) is "tune", each entry verified under its
    index.  Bench reports are recognized and refused as unsupported in the
    port.
    """
    path = Path(path)
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        return "unknown", [_err("schema.malformed", "",
                                f"{path}: unreadable JSON: {e}")]
    stem = path.stem
    digest = stem if len(stem) == 32 and \
        all(c in "0123456789abcdef" for c in stem) else None
    if isinstance(doc, list) and doc and all(
            isinstance(e, dict) and "key" in e and "tile" in e for e in doc):
        return "tune", [dataclasses.replace(d, node=f"#{i}")
                        for i, e in enumerate(doc)
                        for d in verify_tune_entry(e)]
    if not isinstance(doc, dict):
        return "unknown", [_err("schema.malformed", "",
                                f"{path}: not a JSON object")]
    if doc.get("format") == "repro.plan_portfolio":
        return "portfolio", verify_portfolio(doc, stats=stats)
    if doc.get("format") == "repro.compiled_network":
        return "artifact", (verify_artifact(doc, stats=stats)
                            + _sidecar_diags(path, doc))
    if "provenance" in doc and "schedule" in doc:
        return "plan", verify_plan(doc, expect_key=digest, stats=stats)
    if "key" in doc and "tile" in doc:
        return "tune", verify_tune_entry(doc, expect_key=digest)
    if "suite" in doc and "metrics" in doc:
        return "bench", _unsupported("bench", path)
    return "unknown", [Diagnostic(
        SEV_WARNING, "schema.malformed", "",
        f"{path}: unrecognized document shape (no known format markers)")]
