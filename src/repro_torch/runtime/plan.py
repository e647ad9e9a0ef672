"""Compiled co-execution plans, as the port reads them.

The JAX package compiles a network offline into a `CoexecPlan`: the full
per-node `PartitionDecision` schedule plus the provenance needed to know
when it is safe to reuse (device, threads, sync mechanism, candidate-grid
step, network fingerprint, predictor checksum).  The plan JSON is the
contract between the two packages: this module is the port's copy of the
decode side of `repro.runtime.plan`, so one plan document decodes to the
same schedule, graph, provenance key and exec specs in both.

Loading is strict by default, as in the reference: `CoexecPlan.from_json`
(and `loads`/`load`) statically verifies the document first
(`repro_torch.analysis.verify_plan`) and raises `VerificationError` on any
error diagnostic; `verify=False` loads a quarantined document anyway.

Planning-only content travels as metadata:

  * a decision's `tile` key is a TPU blocking choice for the Pallas kernel
    it was tuned for; the verifier checks it against the reference's TPU
    tile table (`kernels.registry.TileSpec`), and it is kept on the
    decision and the spec, never applied to the port's kernels;
  * embedded `segments` metadata is carried through `to_json`; the
    verifier holds it to the partition `Graph.segments` derives, and the
    fused walk executes it (`segment_partition`), re-deriving it from the
    graph where an unverified document's metadata does not cover the
    schedule.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, FrozenSet, List, Optional, Union

from repro_torch.core.networks import Unit
from repro_torch.core.planner import PlanReport
from repro_torch.core.types import Op
from repro_torch.graph.ir import Graph, Segment, from_units
from repro_torch.kernels.registry import (TileConfig, op_from_json, op_kind,
                                          op_label, resolve_tile,
                                          tile_from_json, validate_axis_split)

PLAN_SCHEMA_VERSION = 1

#: the planner provenance records when it names none
PLANNER_PREDICTOR = "predictor"


# -------------------------------------------------------------- decisions

@dataclasses.dataclass(frozen=True)
class PartitionDecision:
    """One node's planned split: `c_gpu` units on the fast group, `c_cpu`
    on the slow group, with the planner's predicted latencies.  `tile` is
    the TPU tile config the plan carries (validated against the
    reference's TPU tile table, never applied to the port's kernels)."""

    op: Op
    c_cpu: int
    c_gpu: int
    pred_cpu_us: float
    pred_gpu_us: float
    pred_total_us: float
    axis: str = "channel"
    tile: Optional[TileConfig] = None

    @property
    def exclusive(self) -> bool:
        return self.c_cpu == 0 or self.c_gpu == 0


def _validate_decision(dec: PartitionDecision) -> PartitionDecision:
    if dec.c_cpu < 0 or dec.c_gpu < 0:
        raise ValueError(f"negative split {dec.c_gpu}/{dec.c_cpu} for "
                         f"{op_label(dec.op)}")
    # typed splits (head, kv-block, ssm-state) go through the registry's
    # validation, as the reference's codec does: an illegal one cannot load
    if dec.axis not in ("channel", "none"):
        validate_axis_split(dec.op, dec.axis, dec.c_gpu)
    if dec.axis == "channel" and op_kind(dec.op) in ("linear", "conv") \
            and dec.c_cpu + dec.c_gpu != dec.op.C_out:
        raise ValueError(
            f"channel split {dec.c_gpu}+{dec.c_cpu} does not cover C_out="
            f"{dec.op.C_out} of {op_label(dec.op)}")
    # an illegal TPU tile (misaligned, over the padded extents or the VMEM
    # budget) cannot load either
    if dec.tile is not None:
        resolve_tile(dec.op, dec.tile)
    return dec


def decision_from_json(d: Dict[str, Any]) -> PartitionDecision:
    op = op_from_json(d["op"])
    tile = (tile_from_json(op_kind(op), d["tile"])
            if "tile" in d else None)
    return _validate_decision(PartitionDecision(
        op=op, c_cpu=d["c_cpu"], c_gpu=d["c_gpu"],
        pred_cpu_us=d["pred_cpu_us"], pred_gpu_us=d["pred_gpu_us"],
        pred_total_us=d["pred_total_us"], axis=d.get("axis", "channel"),
        tile=tile))


# ------------------------------------------------------------- provenance

@dataclasses.dataclass(frozen=True)
class PlanProvenance:
    """Everything a compiled plan's validity depends on; `key` is the
    reference's digest over it (the plan-cache key)."""

    device: str
    threads: int
    mechanism: str
    step: int
    seed: int
    network_fingerprint: str
    predictor_checksum: str
    planner: str = PLANNER_PREDICTOR
    schema_version: int = PLAN_SCHEMA_VERSION
    calibration: str = ""
    bucket: str = ""
    tune: str = ""

    def _canonical(self) -> Dict[str, Any]:
        # empty calibration/bucket/tune are omitted, as the reference does
        d = dataclasses.asdict(self)
        for k in ("calibration", "bucket", "tune"):
            if not d.get(k):
                d.pop(k, None)
        return d

    @property
    def key(self) -> str:
        blob = json.dumps(self._canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()

    def to_json(self) -> Dict[str, Any]:
        return self._canonical()

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "PlanProvenance":
        return PlanProvenance(**d)


# ------------------------------------------------------------- exec specs

@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Executable lowering of one schedule entry (the reference's runtime
    contract): the unit kind, the partition axis, how many units of that
    axis each group owns (`c_fast` = the GPU share, `c_slow` = the CPU
    share: output channels on the channel axis, query or state heads on
    head / ssm-state, cache positions on kv-block) and the predicted
    latency.  `tile` is the plan's TPU tile (not applied); `node_id` and
    `segment` are metadata, excluded from equality."""

    unit: str
    op: Optional[Op] = None
    pool_bytes: int = 0
    c_fast: int = 0
    c_slow: int = 0
    pred_total_us: float = 0.0
    axis: str = "channel"
    tile: Optional[TileConfig] = None
    node_id: str = dataclasses.field(default="", compare=False)
    segment: int = dataclasses.field(default=-1, compare=False)

    @property
    def exclusive(self) -> bool:
        return self.c_fast == 0 or self.c_slow == 0

    @property
    def coexec(self) -> bool:
        return self.op is not None and not self.exclusive


def decision_to_spec(dec: PartitionDecision, node_id: str = "") -> ExecSpec:
    """GPU share -> fast group, CPU share -> slow group."""
    return ExecSpec(unit=op_kind(dec.op), op=dec.op, c_fast=dec.c_gpu,
                    c_slow=dec.c_cpu, pred_total_us=dec.pred_total_us,
                    axis=dec.axis, tile=dec.tile, node_id=node_id)


def spec_label(spec: ExecSpec) -> str:
    """Human-readable label of one spec (the reference's format)."""
    if spec.unit == "pool":
        return f"pool {spec.pool_bytes}B"
    if spec.unit == "add":
        return f"add {spec.node_id}".rstrip()
    label = op_label(spec.op)
    if spec.tile is not None:
        label += f" tile[{spec.tile.label()}]"
    return label


# ------------------------------------------------------------------- plan

@dataclasses.dataclass
class CoexecPlan:
    """A compiled co-execution schedule (decode side).

    `schedule` mirrors the network graph in topological order: pool nodes
    as `{"unit": "pool", "bytes": n}`, add joins as `{"unit": "add"}`,
    conv/linear nodes with their `decision`, attention/ssm nodes with
    their op.  Unit-chain plans carry no ids and no embedded graph (their
    ids are the positions "n{i}"); other plans embed `graph_json`.
    """

    provenance: PlanProvenance
    schedule: List[Dict[str, Any]]
    baseline_us: Optional[float] = None
    individual_us: Optional[float] = None
    end_to_end_us: Optional[float] = None
    graph_json: Optional[Dict[str, Any]] = None
    segments: Optional[List[Dict[str, Any]]] = None

    @property
    def key(self) -> str:
        return self.provenance.key

    def node_ids(self) -> List[str]:
        return [e.get("id", f"n{i}") for i, e in enumerate(self.schedule)]

    @property
    def decisions(self) -> List[PartitionDecision]:
        return [decision_from_json(e["decision"]) for e in self.schedule
                if "decision" in e]

    @property
    def decisions_by_node(self) -> Dict[str, PartitionDecision]:
        """Per-node partition decisions keyed by graph node id."""
        return {nid: decision_from_json(e["decision"])
                for nid, e in zip(self.node_ids(), self.schedule)
                if "decision" in e}

    @property
    def units(self) -> List[Unit]:
        if self.graph_json is not None:
            raise ValueError("this plan was compiled over a non-chain "
                             "graph; use plan.graph_ir()")
        out: List[Unit] = []
        for e in self.schedule:
            if e["unit"] == "pool":
                out.append(("pool", e["bytes"]))
            else:
                out.append((e["unit"], op_from_json(e["decision"]["op"])))
        return out

    def graph_ir(self) -> Graph:
        """The plan's network graph: embedded for DAG plans, rebuilt from
        the schedule for unit chains."""
        cached = getattr(self, "_graph_ir", None)
        if cached is None:
            cached = (Graph.from_json(self.graph_json)
                      if self.graph_json is not None
                      else from_units(self.units))
            self._graph_ir = cached
        return cached

    def check_graph(self) -> None:
        """Raise unless the plan's graph digests to its provenance's
        network fingerprint and every schedule entry's kind matches its
        graph node (a plan compiled for another graph, or corrupted)."""
        graph = self.graph_ir()
        fp = graph.fingerprint()
        if fp != self.provenance.network_fingerprint:
            raise ValueError(
                f"network fingerprint mismatch: the plan's graph digests to "
                f"{fp}, its provenance says "
                f"{self.provenance.network_fingerprint}")
        if [n.kind for n in graph] != [e["unit"] for e in self.schedule]:
            raise ValueError("plan schedule and graph disagree on node "
                             "kinds — corrupt plan")

    def coexec_node_ids(self) -> FrozenSet[str]:
        """Ids of the co-executed channel-split nodes (typed-axis splits
        co-execute too, but stay out of this set, as in the reference:
        it is the set the segment partition is computed over)."""
        ids = []
        for nid, e in zip(self.node_ids(), self.schedule):
            d = e.get("decision")
            if (d is not None and d["c_cpu"] > 0 and d["c_gpu"] > 0
                    and d.get("axis") in (None, "channel")):
                ids.append(nid)
        return frozenset(ids)

    def segment_partition(self) -> List[Segment]:
        """The segment partition of this plan's schedule: the embedded
        `segments` metadata where it covers the schedule exactly, else
        `graph_ir().segments(coexec_node_ids())` (the planners embed
        exactly that, so the two agree)."""
        cached = getattr(self, "_segment_partition", None)
        if cached is not None:
            return cached
        parts: Optional[List[Segment]] = None
        if self.segments is not None:
            parts = [Segment(kind=e["kind"], node_ids=tuple(e["nodes"]))
                     for e in self.segments]
            covered = [nid for s in parts for nid in s.node_ids]
            if covered != self.node_ids():      # stale metadata: re-derive
                parts = None
        if parts is None:
            parts = self.graph_ir().segments(self.coexec_node_ids())
        self._segment_partition = parts
        return parts

    def segment_of(self) -> Dict[str, int]:
        """node id -> segment-partition index."""
        return {nid: k for k, seg in enumerate(self.segment_partition())
                for nid in seg.node_ids}

    def exec_specs(self) -> List[ExecSpec]:
        """The schedule lowered to executable specs, in topological order
        (the input contract of `runtime.executor.PlanExecutor`)."""
        out: List[ExecSpec] = []
        for nid, e in zip(self.node_ids(), self.schedule):
            if e["unit"] == "pool":
                out.append(ExecSpec(unit="pool", pool_bytes=int(e["bytes"]),
                                    node_id=nid))
            elif e["unit"] == "add":
                out.append(ExecSpec(unit="add", node_id=nid))
            elif "decision" in e:
                out.append(decision_to_spec(decision_from_json(
                    e["decision"]), node_id=nid))
            else:                       # legacy attention / ssm: exclusive
                out.append(ExecSpec(unit=e["unit"],
                                    op=op_from_json(e["op"]),
                                    pred_total_us=float(e.get("pred_us",
                                                              0.0)),
                                    axis="none", node_id=nid))
        seg_of = self.segment_of()
        return [dataclasses.replace(s, segment=seg_of.get(s.node_id, -1))
                for s in out]

    # ------------------------------------------------------------- codecs
    def to_json(self) -> Dict[str, Any]:
        doc = {"schema_version": self.provenance.schema_version,
               "provenance": self.provenance.to_json(),
               "schedule": self.schedule,
               "report": {"baseline_us": self.baseline_us,
                          "individual_us": self.individual_us,
                          "end_to_end_us": self.end_to_end_us}}
        if self.graph_json is not None:
            doc["graph"] = self.graph_json
        if self.segments is not None:
            doc["segments"] = self.segments
        return doc

    def report(self) -> Optional[PlanReport]:
        """The planning-time report the document carries (None when it
        records no end-to-end latency)."""
        if self.end_to_end_us is None:
            return None
        return PlanReport(device=self.provenance.device,
                          threads=self.provenance.threads,
                          baseline_us=self.baseline_us,
                          individual_us=self.individual_us,
                          end_to_end_us=self.end_to_end_us,
                          decisions=self.decisions)

    @staticmethod
    def from_json(d: Dict[str, Any], *, verify: bool = True) -> "CoexecPlan":
        """Decode a plan document.

        ``verify=True`` (default) statically verifies the document first
        (`repro_torch.analysis.verify_plan`) and raises `VerificationError`
        on error diagnostics, so a corrupted or hand-edited plan is refused
        at load, with the reference's rule ids.  ``verify=False`` loads it
        anyway (e.g. to inspect a quarantined artifact), as the reference
        does."""
        if verify:
            from repro_torch.analysis import raise_on_error, verify_plan
            raise_on_error(verify_plan(d, stats=False), "plan document")
        rep = d.get("report") or {}
        return CoexecPlan(provenance=PlanProvenance.from_json(d["provenance"]),
                          schedule=d["schedule"],
                          baseline_us=rep.get("baseline_us"),
                          individual_us=rep.get("individual_us"),
                          end_to_end_us=rep.get("end_to_end_us"),
                          graph_json=d.get("graph"),
                          segments=d.get("segments"))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=1)

    @staticmethod
    def loads(text: str, *, verify: bool = True) -> "CoexecPlan":
        return CoexecPlan.from_json(json.loads(text), verify=verify)

    def save(self, path: Union[str, Path]) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.dumps())

    @staticmethod
    def load(path: Union[str, Path], *, verify: bool = True) -> "CoexecPlan":
        return CoexecPlan.loads(Path(path).read_text(), verify=verify)
