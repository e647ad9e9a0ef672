"""Persistent plan cache: compile once, execute many.

`PlanCache` stores `CoexecPlan` JSON files under one directory, keyed by the
plan's provenance digest.  The cached planning entry points below check the
cache *before* touching the predictors or the simulator, so a warm hit
performs zero `LatencyPredictor.predict` and zero `measure_latency_us`
calls — repeated planning of the same (network, device, mechanism, threads,
predictors) tuple costs one JSON read.

`plan_graph_cached` / `grid_plan_graph_cached` are the graph-IR entry
points; the unit-list spellings (`plan_network_cached`,
`grid_plan_network_cached`) are thin lowering shims over them via
`graph.from_units` — provenance-identical to the pre-IR implementations
(chain graphs fingerprint to the legacy unit-list digest), so existing
on-disk caches stay warm across the representation change.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.core.networks import Unit
from repro_torch.core.partitioner import (PartitionDecision,
                                          optimal_partition_batch)
from repro_torch.core.planner import grid_plan_graph, plan_graph
from repro_torch.core.sync import SyncMechanism
from repro_torch.core.types import Op
from repro_torch.graph.ir import Graph, from_units
from repro_torch.runtime.plan import (PLANNER_GRID, PLANNER_PREDICTOR,
                                      CoexecPlan, PlanProvenance, build_schedule,
                                      calibration_version,
                                      network_fingerprint,
                                      plan_from_graph_report, predictor_checksum)


class PlanCache:
    """On-disk cache of compiled co-execution plans.

    One JSON file per provenance key; `hits`/`misses` count lookups since
    construction (tests assert on them).  Corrupt or mismatched files are
    treated as misses and overwritten, never trusted.
    """

    def __init__(self, root: Path):
        self.root = Path(root)
        self.hits = 0
        self.misses = 0

    def path_for(self, provenance: PlanProvenance) -> Path:
        return self.root / f"{provenance.key}.json"

    def get(self, provenance: PlanProvenance) -> Optional[CoexecPlan]:
        from repro_torch.analysis import VerificationError, rejections
        path = self.path_for(provenance)
        if path.exists():
            try:
                plan = CoexecPlan.load(path)
            except VerificationError as e:
                first = e.diagnostics[0]
                rejections.record(path.stem, first.rule, first.message)
                plan = None
            except (ValueError, KeyError, TypeError) as e:
                rejections.record(path.stem, "schema.malformed", str(e))
                plan = None
            if plan is not None:
                if plan.provenance == provenance:
                    self.hits += 1
                    return plan
                import dataclasses
                fields = [f.name for f in dataclasses.fields(provenance)
                          if getattr(plan.provenance, f.name, None) !=
                          getattr(provenance, f.name, None)]
                rejections.record(path.stem, "provenance.mismatch",
                                  f"stale fields: {fields}")
        self.misses += 1
        return None

    def put(self, plan: CoexecPlan) -> Path:
        path = self.path_for(plan.provenance)
        plan.save(path)
        return path

    def keys(self) -> List[str]:
        if not self.root.is_dir():
            return []
        return sorted(p.stem for p in self.root.glob("*.json"))


def plan_graph_cached(graph: Graph, cpu_pred, gpu_pred, *,
                      threads: int,
                      mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                      step: int = 8, seed: int = 1,
                      bucket: str = "",
                      tune: str = "", annotate=None,
                      cache: PlanCache) -> CoexecPlan:
    """End-to-end graph planning through the cache.

    Provenance (and therefore the cache key) covers the graph's
    content-addressed fingerprint, the target (device, threads), the sync
    mechanism, the candidate-grid step, the measurement seed, a structural
    checksum of both predictors and, when the predictors are calibrated
    (`repro_torch.measure.Calibrator.wrap`), the calibration version, so
    refit calibrators never alias stale plans.  `bucket` tags the (batch,
    seq) serving bucket a portfolio entry was compiled for; it folds into
    the digest (omitted when empty, so unbucketed keys are unchanged) and
    lets portfolio compiles warm-hit across processes.  `tune` tags a
    tuned compile's plan with its tune-cache version
    (`runtime.autotune.tune_cache_version`); it folds into the digest the
    same way, so tuned and untuned plans never alias, and `annotate` (a
    plan -> plan hook applied on a miss, before the plan is stored) is
    where the tune pass runs, so a warm hit skips it.
    """
    prov = PlanProvenance(
        device=gpu_pred.device, threads=threads, mechanism=mechanism.value,
        step=step, seed=seed,
        network_fingerprint=graph.fingerprint(),
        predictor_checksum=predictor_checksum(cpu_pred, gpu_pred),
        planner=PLANNER_PREDICTOR,
        calibration=calibration_version(cpu_pred, gpu_pred), bucket=bucket,
        tune=tune)
    hit = cache.get(prov)
    if hit is not None:
        return hit
    report = plan_graph(graph, cpu_pred, gpu_pred, threads=threads,
                        mechanism=mechanism, step=step, seed=seed)
    plan = plan_from_graph_report(graph, report, mechanism=mechanism,
                                  step=step, seed=seed,
                                  pred_checksum=prov.predictor_checksum,
                                  calibration=prov.calibration,
                                  bucket=bucket, tune=tune)
    if annotate is not None:
        plan = annotate(plan)
    cache.put(plan)
    return plan


def plan_network_cached(units: Sequence[Unit], cpu_pred, gpu_pred, *,
                        threads: int,
                        mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                        step: int = 8, seed: int = 1,
                        cache: PlanCache) -> CoexecPlan:
    """Legacy unit-list spelling: lowers through `graph.from_units` into
    `plan_graph_cached`.  Chain graphs fingerprint identically to the old
    unit-list digest and their schedules serialize in the pre-IR format,
    so cache entries (keys *and* file bytes) are unchanged."""
    return plan_graph_cached(from_units(units), cpu_pred, gpu_pred,
                             threads=threads, mechanism=mechanism,
                             step=step, seed=seed, cache=cache)


def _ops_as_units(ops: Sequence[Op]) -> List[Unit]:
    from repro_torch.core.types import LinearOp
    return [("linear" if isinstance(op, LinearOp) else "conv", op)
            for op in ops]


def partition_ops_plan_cached(ops: Sequence[Op], cpu_pred, gpu_pred, *,
                              mechanism: SyncMechanism =
                              SyncMechanism.SVM_POLL,
                              step: int = 8,
                              tune: str = "", annotate=None,
                              cache: PlanCache) -> CoexecPlan:
    """Predictor-driven partitioning of a bare op list through the cache,
    returned as the full `CoexecPlan` artifact (the Table 2 sweeps and
    `repro_torch.compile(ops, ...)` go through here).

    Bare op lists carry no thread count or measurement seed in their
    provenance (threads=0, seed=0): predictions are deterministic and the
    CPU predictor already embeds its thread count in the checksum.
    """
    units = _ops_as_units(ops)
    prov = PlanProvenance(
        device=gpu_pred.device, threads=0, mechanism=mechanism.value,
        step=step, seed=0, network_fingerprint=network_fingerprint(units),
        predictor_checksum=predictor_checksum(cpu_pred, gpu_pred),
        planner=PLANNER_PREDICTOR,
        calibration=calibration_version(cpu_pred, gpu_pred), tune=tune)
    hit = cache.get(prov)
    if hit is not None:
        return hit
    decisions = optimal_partition_batch(ops, cpu_pred, gpu_pred,
                                        mechanism=mechanism, step=step)
    plan = CoexecPlan(provenance=prov,
                      schedule=build_schedule(units, decisions))
    if annotate is not None:
        plan = annotate(plan)
    cache.put(plan)
    return plan


def partition_ops_cached(ops: Sequence[Op], cpu_pred, gpu_pred, *,
                         mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                         step: int = 8,
                         cache: PlanCache) -> List[PartitionDecision]:
    """Predictor-driven partitioning of a bare op list through the cache;
    decisions come back in op order (thin wrapper over the plan-returning
    variant — identical provenance, so the two share cache entries)."""
    return partition_ops_plan_cached(ops, cpu_pred, gpu_pred,
                                     mechanism=mechanism, step=step,
                                     cache=cache).decisions


def grid_plan_graph_cached(graph: Graph, device: str, threads: int, *,
                           mechanism: SyncMechanism =
                           SyncMechanism.SVM_POLL,
                           step: int = 8, seed: int = 0,
                           tune: str = "", annotate=None,
                           cache: PlanCache) -> CoexecPlan:
    """Measurement-driven (oracle) planning of a graph through the cache;
    keyed by planner="grid" with no predictor checksum (none is involved).
    Pool/add nodes pass through unsplit; attention/ssm nodes are charged
    analytically (the grid oracle has no measurement model for them)."""
    prov = PlanProvenance(
        device=device, threads=threads, mechanism=mechanism.value,
        step=step, seed=seed, network_fingerprint=graph.fingerprint(),
        predictor_checksum="", planner=PLANNER_GRID, tune=tune)
    hit = cache.get(prov)
    if hit is not None:
        return hit
    report = grid_plan_graph(graph, device, threads, mechanism=mechanism,
                             step=step, seed=seed)
    plan = plan_from_graph_report(graph, report, mechanism=mechanism,
                                  step=step, seed=seed, pred_checksum="",
                                  planner=PLANNER_GRID, tune=tune,
                                  with_totals=False)
    if annotate is not None:
        plan = annotate(plan)
    cache.put(plan)
    return plan


def grid_plan_network_cached(units: Sequence[Unit], device: str,
                             threads: int, *,
                             mechanism: SyncMechanism =
                             SyncMechanism.SVM_POLL,
                             step: int = 8, seed: int = 0,
                             cache: PlanCache) -> CoexecPlan:
    """Legacy unit-list spelling of `grid_plan_graph_cached` (lowers via
    `graph.from_units`; provenance and file bytes unchanged)."""
    return grid_plan_graph_cached(from_units(units), device, threads,
                                  mechanism=mechanism, step=step,
                                  seed=seed, cache=cache)


def grid_partition_ops_cached(ops: Sequence[Op], device: str, threads: int, *,
                              mechanism: SyncMechanism =
                              SyncMechanism.SVM_POLL,
                              step: int = 8, seed: int = 0,
                              cache: PlanCache) -> List[PartitionDecision]:
    """Measurement-driven (oracle) partitioning of a bare op list through
    the cache (wrapper over `grid_plan_network_cached` on ops-as-units —
    identical provenance, shared cache entries)."""
    return grid_plan_network_cached(_ops_as_units(ops), device, threads,
                                    mechanism=mechanism, step=step,
                                    seed=seed, cache=cache).decisions
