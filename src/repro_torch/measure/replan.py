"""Adaptive replanning: repair a compiled plan with calibrated predictors.

The port's copy of the reference's replanner.  `replan(plan, cpu_pred,
gpu_pred, calibrator, cache=...)` re-runs the *cached* planners with
calibration-wrapped predictors and returns the new `CoexecPlan` plus a
`PlanDiff` against the old one.  The calibrator's version is folded into
plan provenance, so the new plan lands under a **new** cache key: the old
entry is untouched, and replanning with the same calibrator is a warm hit.

The diff scores *both* schedules under the calibrated predictors, so
`predicted_gain_us` is apples to apples: the old decisions are re-priced
on the grid the new ones were chosen from, which also keeps the gain
non-negative (the new schedule is that grid's per-op argmin).  The same
inputs give the reference's plan, key and `PlanDiff.to_json()`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.core.partitioner import PartitionDecision
from repro_torch.core.sync import SyncMechanism, sync_overhead_us
from repro_torch.kernels import registry
from repro_torch.measure.calibrate import Calibrator
from repro_torch.runtime.cache import (PlanCache, partition_ops_plan_cached,
                                 plan_graph_cached)
from repro_torch.runtime.plan import PLANNER_PREDICTOR, CoexecPlan, op_label


def score_decisions(decisions: List[PartitionDecision], cpu_pred, gpu_pred,
                    *, mechanism: SyncMechanism) -> np.ndarray:
    """Price a decision list under (possibly calibrated) predictors —
    the partitioner's objective, evaluated at fixed splits.

    Channel decisions (conv/linear) are priced at their `with_cout`
    sub-ops; typed-axis decisions (head / kv-block / ssm-state, and
    exclusive `none` placements) at their `axis_side_ops` sub-ops, with
    the same non-stackable merge surcharge `_axis_decide` charges — so a
    replanned attention/SSM schedule is re-priced on the grid it was
    chosen from."""
    if not decisions:
        return np.empty(0)
    from repro_torch.core.partitioner import axis_side_ops
    from repro_torch.core.simulator.devices import DEVICES
    gpu_ops, cpu_ops, extra = [], [], []
    for d in decisions:
        if d.axis == "channel":
            gpu_ops.append(d.op.with_cout(d.c_gpu))
            cpu_ops.append(d.op.with_cout(d.c_cpu))
            extra.append(0.0)
        else:
            g, c = axis_side_ops(d)
            gpu_ops.append(g)
            cpu_ops.append(c)
            stackable = d.exclusive or d.axis == "none" or registry.axis_spec(
                registry.op_kind(d.op), d.axis).stackable
            extra.append(0.0 if stackable else 2.0 * d.op.output_bytes)
    c_gpu = np.array([d.c_gpu for d in decisions])
    c_cpu = np.array([d.c_cpu for d in decisions])
    t_gpu = np.where(c_gpu > 0, gpu_pred.predict(gpu_ops), 0.0)
    t_cpu = np.where(c_cpu > 0, cpu_pred.predict(cpu_ops), 0.0)
    device = gpu_pred.device
    overhead = sync_overhead_us(device, mechanism)
    extra = np.asarray(extra)
    merge_us = extra / (DEVICES[device].cpu_mem_gbps * 1e3)
    merge_us = merge_us + np.where(extra > 0.0, overhead, 0.0)
    coexec = (c_gpu > 0) & (c_cpu > 0)
    return np.maximum(t_cpu, t_gpu) + np.where(coexec, overhead + merge_us,
                                               0.0)


@dataclasses.dataclass(frozen=True)
class DecisionChange:
    """One op whose split moved between the old and the new plan."""

    index: int                   # schedule position
    label: str
    old_c_cpu: int
    old_c_gpu: int
    new_c_cpu: int
    new_c_gpu: int
    old_pred_us: float           # calibrated score of the old split
    new_pred_us: float           # calibrated score of the new split
    node_id: str = ""            # graph node id of the changed op

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PlanDiff:
    """What replanning changed, priced under the calibrated predictors."""

    old_key: str
    new_key: str
    calibration: str             # calibrator version the new plan embeds
    n_ops: int
    changes: List[DecisionChange]
    old_total_us: float          # calibrated score of the old schedule
    new_total_us: float          # calibrated score of the new schedule

    @property
    def predicted_gain_us(self) -> float:
        return self.old_total_us - self.new_total_us

    def to_json(self) -> Dict[str, Any]:
        return {"old_key": self.old_key, "new_key": self.new_key,
                "calibration": self.calibration, "n_ops": self.n_ops,
                "old_total_us": self.old_total_us,
                "new_total_us": self.new_total_us,
                "predicted_gain_us": self.predicted_gain_us,
                "changes": [c.to_json() for c in self.changes]}

    def summary(self) -> str:
        head = (f"plan diff: {len(self.changes)}/{self.n_ops} ops changed, "
                f"predicted {self.old_total_us / 1e3:.2f} ms -> "
                f"{self.new_total_us / 1e3:.2f} ms "
                f"(gain {self.predicted_gain_us / 1e3:.2f} ms) "
                f"under calibration {self.calibration or '<none>'}")
        lines = [head,
                 f"  key {self.old_key} -> {self.new_key}"]
        for c in self.changes:
            tag = c.node_id or str(c.index)
            lines.append(
                f"  [{tag:>3}] {c.label:<42} cpu/gpu "
                f"{c.old_c_cpu}/{c.old_c_gpu} -> "
                f"{c.new_c_cpu}/{c.new_c_gpu} "
                f"(pred {c.old_pred_us:.1f} -> {c.new_pred_us:.1f} us)")
        return "\n".join(lines)


def diff_plans(old: CoexecPlan, new: CoexecPlan, cpu_pred, gpu_pred, *,
               mechanism: SyncMechanism,
               calibration: str = "") -> PlanDiff:
    """Per-op decision diff of two plans over the same network, priced
    under the given (typically calibrated) predictors."""
    if (old.provenance.network_fingerprint
            != new.provenance.network_fingerprint):
        raise ValueError("cannot diff plans over different networks "
                         f"({old.provenance.network_fingerprint} != "
                         f"{new.provenance.network_fingerprint})")
    old_dec, new_dec = old.decisions, new.decisions
    old_us = score_decisions(old_dec, cpu_pred, gpu_pred,
                             mechanism=mechanism)
    new_us = score_decisions(new_dec, cpu_pred, gpu_pred,
                             mechanism=mechanism)
    changes: List[DecisionChange] = []
    op_i = 0
    for idx, (nid, entry) in enumerate(zip(old.node_ids(), old.schedule)):
        if "decision" not in entry:      # pool/add: never partitioned
            continue
        o, n = old_dec[op_i], new_dec[op_i]
        if (o.c_cpu, o.c_gpu) != (n.c_cpu, n.c_gpu):
            changes.append(DecisionChange(
                index=idx, label=op_label(o.op),
                old_c_cpu=o.c_cpu, old_c_gpu=o.c_gpu,
                new_c_cpu=n.c_cpu, new_c_gpu=n.c_gpu,
                old_pred_us=float(old_us[op_i]),
                new_pred_us=float(new_us[op_i]),
                node_id=nid))
        op_i += 1
    return PlanDiff(old_key=old.key, new_key=new.key,
                    calibration=calibration, n_ops=len(old_dec),
                    changes=changes,
                    old_total_us=float(np.sum(old_us)),
                    new_total_us=float(np.sum(new_us)))


def replan(plan: CoexecPlan, cpu_pred, gpu_pred, calibrator: Calibrator, *,
           cache: PlanCache) -> Tuple[CoexecPlan, PlanDiff]:
    """Re-run the cached planner that produced `plan` with calibrated
    predictors; returns (new_plan, diff).

    The plan's own provenance selects the planning path: network/graph
    plans (threads > 0, pool units, or a non-chain graph) go through
    `plan_graph_cached` over the plan's own graph, bare-op plans through
    `partition_ops_plan_cached` — same mechanism, step and seed as the
    original, so the *only* provenance deltas are the calibration version
    (and any decision changes it causes).
    """
    prov = plan.provenance
    if prov.planner != PLANNER_PREDICTOR:
        raise ValueError(
            f"can only replan predictor-driven plans (planner="
            f"{prov.planner!r}); grid plans are measurement-driven")
    cp = calibrator.wrap(cpu_pred)
    gp = calibrator.wrap(gpu_pred)
    mech = SyncMechanism(prov.mechanism)
    graph = plan.graph_ir()
    is_chain = graph.is_unit_chain()
    has_pool = any(n.kind == "pool" for n in graph)
    if not is_chain or prov.threads > 0 or has_pool:
        # the bucket tag survives replanning: a portfolio entry's repaired
        # plan still answers for the same (batch, seq) bucket
        new = plan_graph_cached(graph, cp, gp, threads=prov.threads,
                                mechanism=mech, step=prov.step,
                                seed=prov.seed, bucket=prov.bucket,
                                cache=cache)
    else:
        new = partition_ops_plan_cached([n.op for n in graph], cp, gp,
                                        mechanism=mech, step=prov.step,
                                        cache=cache)
    diff = diff_plans(plan, new, cp, gp, mechanism=mech,
                      calibration=calibrator.version)
    return new, diff
