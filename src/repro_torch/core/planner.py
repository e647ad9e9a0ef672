"""End-to-end model partition planning (paper Section 5.4).

Runs the per-operation partitioner over a whole network graph (offline, as
"part of the compilation process"), then evaluates:

  * baseline        — every op on the GPU;
  * individual ops  — sum of each op's co-execution latency in isolation;
  * end-to-end      — co-execution schedule including inter-layer effects:
    pooling stays on the GPU (free of sync overhead), and a boundary cost is
    charged when consecutive layers change their channel split, because each
    side then consumes activations the *other* side produced (extra
    cache-coherent traffic through the shared memory) — this is the paper's
    observed "memory access overhead between layers" that makes end-to-end
    speedups slightly lower than per-op speedups.

The whole network is planned in a fixed number of batched calls: one
baseline measurement batch, two predictor batches covering every candidate
split of every op, and two realized-latency measurement batches — no
per-candidate (or per-op) Python loops on the scoring hot path.

`plan_graph` is the IR-era entry point: it walks a `graph.ir.Graph` in
topological order, partitions every *splittable* node (conv/linear) through
the same batched calls, and charges non-splittable op nodes (attention,
ssm) an analytic GPU-side latency (`opaque_latency_us`) — they stay
unsplit, like pooling, but unlike pooling they are real compute whose
charge scales with the op.  On a unit-chain graph the walk performs the
identical float operations in the identical order as `plan_network`, so
decisions *and* totals are bit-equal — the compatibility contract the
plan cache relies on.  `plan_network` remains the legacy unit-list
implementation (and the reference the equivalence tests pin against).

This is the port's copy of `repro.core.planner`: host-side numpy, with the
reference's float operations in the reference's order, so a plan compiled
here is the reference's plan byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Sequence

from repro_torch.core.networks import Unit
from repro_torch.core.partitioner import (PartitionDecision,
                                          axis_partition_batch,
                                          axis_realized_latency_us_batch,
                                          optimal_partition_batch,
                                          realized_latency_us_batch)
from repro_torch.core.predictor.train import LatencyPredictor
from repro_torch.core.simulator.devices import DEVICES
from repro_torch.core.simulator.measure import measure_latency_us_batch
from repro_torch.core.sync import SyncMechanism
from repro_torch.core.types import Op
from repro_torch.kernels import registry

if TYPE_CHECKING:
    from repro_torch.graph.ir import Graph


@dataclasses.dataclass
class PlanReport:
    device: str
    threads: int
    baseline_us: float          # all-GPU
    individual_us: float        # sum of isolated co-exec latencies
    end_to_end_us: float        # schedule incl. boundary costs
    decisions: List[PartitionDecision]

    @property
    def individual_speedup(self) -> float:
        return self.baseline_us / self.individual_us

    @property
    def end_to_end_speedup(self) -> float:
        return self.baseline_us / self.end_to_end_us


def _pool_latency_us(device: str) -> float:
    # pooling is bandwidth-trivial; charge one dispatch (paper: negligible)
    return DEVICES[device].gpu_dispatch_us * 0.6


def plan_network(units: Sequence[Unit], cpu_pred: LatencyPredictor,
                 gpu_pred: LatencyPredictor, *, threads: int,
                 mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                 step: int = 8, seed: int = 1) -> PlanReport:
    device = gpu_pred.device
    dev = DEVICES[device]

    ops = [payload for kind, payload in units if kind != "pool"]
    gpu_only = measure_latency_us_batch(ops, device, "gpu", seed=seed)
    decisions = optimal_partition_batch(ops, cpu_pred, gpu_pred,
                                        mechanism=mechanism, step=step)
    t_co = realized_latency_us_batch(decisions, device, threads,
                                     mechanism=mechanism, seed=seed)

    # Accumulate in schedule order (identical float-add order to a unit-by-
    # unit walk, so totals match the loop formulation exactly).
    baseline = 0.0
    individual = 0.0
    e2e = 0.0
    prev_split_frac = 0.0       # fraction of channels on CPU in previous op
    i = 0
    for kind, payload in units:
        if kind == "pool":
            t = _pool_latency_us(device)
            baseline += t
            individual += t
            e2e += t
            prev_split_frac = 0.0     # pooling runs wholly on GPU
            continue
        op = payload
        baseline += float(gpu_only[i])
        individual += float(t_co[i])

        dec = decisions[i]
        split_frac = dec.c_cpu / max(1, op.C_out)
        # boundary traffic: activations crossing the CPU/GPU ownership
        # boundary between consecutive layers move through shared memory.
        crossing = abs(split_frac - prev_split_frac) * op.input_bytes
        boundary_us = crossing / (dev.cpu_mem_gbps * 1e3)
        e2e += float(t_co[i]) + boundary_us
        prev_split_frac = split_frac
        i += 1

    return PlanReport(device=device, threads=threads, baseline_us=baseline,
                      individual_us=individual, end_to_end_us=e2e,
                      decisions=decisions)


# ----------------------------------------------------------- graph planning

def opaque_latency_us(op: Op, device: str) -> float:
    """Analytic GPU-side charge for a non-splittable op node (attention,
    ssm): one dispatch plus the roofline max of compute and memory time.
    Deterministic — it keys plan caching like every other planning input."""
    dev = DEVICES[device]
    bytes_total = op.input_bytes + op.weight_bytes + op.output_bytes
    compute_us = op.flops / (dev.gpu_gflops * 1e3)
    mem_us = bytes_total / (dev.gpu_mem_gbps * 1e3)
    return dev.gpu_dispatch_us + max(compute_us, mem_us)


@dataclasses.dataclass
class GraphPlanReport:
    """`plan_graph`'s result: per-node decisions keyed by node id.

    `decisions` holds the splittable (conv/linear) nodes' partition
    choices; `opaque_us` the analytic charges of non-splittable op nodes
    (attention/ssm).  Totals follow the `PlanReport` semantics.
    """

    device: str
    threads: int
    baseline_us: float
    individual_us: float
    end_to_end_us: float
    decisions: Dict[str, PartitionDecision]
    opaque_us: Dict[str, float]

    @property
    def individual_speedup(self) -> float:
        return self.baseline_us / self.individual_us

    @property
    def end_to_end_speedup(self) -> float:
        return self.baseline_us / self.end_to_end_us


def _can_price_kind(pred: LatencyPredictor, kind: str) -> bool:
    """Whether a predictor bundle can price an attention/ssm op: a
    `MuxPredictor` trained with the kind's member.  Plain per-kind
    predictors (and legacy conv/linear-only bundles) cannot — those
    planner calls keep the pre-axis opaque-charge behavior."""
    member = getattr(pred, "member", None)
    return member is not None and member(kind) is not None


def _axis_cpu_frac(dec: PartitionDecision) -> float:
    """CPU-resident fraction of a decision's output channels, for the
    boundary-traffic term.  Stackable axis splits own channels pro-rata;
    a kv-block split materializes its merged output GPU-side (0); an
    exclusive CPU placement owns everything (1)."""
    if dec.axis == "channel":
        return dec.c_cpu / max(1, dec.op.C_out)
    if dec.axis == "none":
        return 1.0 if dec.c_gpu == 0 else 0.0
    spec = registry.axis_spec(registry.op_kind(dec.op), dec.axis)
    if not spec.stackable:
        return 0.0
    return dec.c_cpu / max(1, spec.size(dec.op))


def plan_graph(graph: "Graph", cpu_pred: LatencyPredictor,
               gpu_pred: LatencyPredictor, *, threads: int,
               mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
               step: int = 8, seed: int = 1) -> GraphPlanReport:
    """Plan a `graph.ir.Graph` (the IR-era `plan_network`).

    Splittable nodes are partitioned in the same batched predictor /
    measurement calls as the unit-list path; structural nodes (pool, add)
    are charged one trivial GPU dispatch.  Attention/ssm nodes are scored
    over their typed (axis, boundary, mode) candidate grids — two more
    batched predictor calls — when the predictor bundle has their per-kind
    members; otherwise they keep the analytic `opaque_latency_us` charge
    with a forced exclusive placement (the pre-axis behavior, still used
    by conv/linear-only predictor bundles).
    The boundary-traffic term follows graph edges: a node's crossing cost
    compares its CPU-channel fraction against its *producer's* (0 for
    structural and opaque producers, which materialize GPU-side) — on a
    chain this is exactly `plan_network`'s consecutive-layer rule.
    """
    device = gpu_pred.device
    dev = DEVICES[device]

    split_nodes = graph.splittable_nodes()
    ops = [n.op for n in split_nodes]
    gpu_only = measure_latency_us_batch(ops, device, "gpu", seed=seed)
    decision_list = optimal_partition_batch(ops, cpu_pred, gpu_pred,
                                            mechanism=mechanism, step=step)
    t_co = realized_latency_us_batch(decision_list, device, threads,
                                     mechanism=mechanism, seed=seed)

    axis_nodes = [n for n in graph
                  if n.op is not None and not n.splittable
                  and _can_price_kind(cpu_pred, n.kind)
                  and _can_price_kind(gpu_pred, n.kind)]
    axis_gpu_only = measure_latency_us_batch([n.op for n in axis_nodes],
                                             device, "gpu", seed=seed)
    axis_list = axis_partition_batch([n.op for n in axis_nodes],
                                     cpu_pred, gpu_pred,
                                     mechanism=mechanism)
    axis_t_co = axis_realized_latency_us_batch(axis_list, device, threads,
                                               mechanism=mechanism,
                                               seed=seed)
    axis_index = {n.id: j for j, n in enumerate(axis_nodes)}

    decisions: Dict[str, PartitionDecision] = {}
    opaque_us: Dict[str, float] = {}
    split_frac: Dict[str, float] = {}      # node id -> CPU-channel fraction
    baseline = 0.0
    individual = 0.0
    e2e = 0.0
    i = 0
    for node in graph:
        if node.splittable:
            op = node.op
            baseline += float(gpu_only[i])
            individual += float(t_co[i])
            dec = decision_list[i]
            decisions[node.id] = dec
            frac = dec.c_cpu / max(1, op.C_out)
            frac_in = split_frac.get(node.inputs[0], 0.0) \
                if node.inputs else 0.0
            crossing = abs(frac - frac_in) * op.input_bytes
            boundary_us = crossing / (dev.cpu_mem_gbps * 1e3)
            e2e += float(t_co[i]) + boundary_us
            split_frac[node.id] = frac
            i += 1
        elif node.id in axis_index:        # attention / ssm: typed axes
            j = axis_index[node.id]
            dec = axis_list[j]
            decisions[node.id] = dec
            baseline += float(axis_gpu_only[j])
            individual += float(axis_t_co[j])
            frac = _axis_cpu_frac(dec)
            frac_in = split_frac.get(node.inputs[0], 0.0) \
                if node.inputs else 0.0
            crossing = abs(frac - frac_in) * node.op.input_bytes
            boundary_us = crossing / (dev.cpu_mem_gbps * 1e3)
            e2e += float(axis_t_co[j]) + boundary_us
            split_frac[node.id] = frac
        elif node.op is not None:          # attention / ssm: exclusive
            t = opaque_latency_us(node.op, device)
            opaque_us[node.id] = t
            baseline += t
            individual += t
            e2e += t
            split_frac[node.id] = 0.0
        else:                              # pool / add: trivial GPU dispatch
            t = _pool_latency_us(device)
            baseline += t
            individual += t
            e2e += t
            split_frac[node.id] = 0.0

    return GraphPlanReport(device=device, threads=threads,
                           baseline_us=baseline, individual_us=individual,
                           end_to_end_us=e2e, decisions=decisions,
                           opaque_us=opaque_us)


def grid_plan_graph(graph: "Graph", device: str, threads: int, *,
                    mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                    step: int = 8, seed: int = 0) -> GraphPlanReport:
    """Measurement-driven (oracle) graph planning: grid-searches every
    splittable node over channels and every attention/ssm node over its
    typed (axis, boundary, mode) grid.  No end-to-end totals — the grid
    oracle is a per-op upper bound (Table 2), so the report carries
    decisions only (totals 0)."""
    from repro_torch.core.partitioner import (grid_axis_partition_batch,
                                              grid_search_partition_batch)

    split_nodes = graph.splittable_nodes()
    decision_list = grid_search_partition_batch(
        [n.op for n in split_nodes], device, threads, mechanism=mechanism,
        step=step, seed=seed)
    decisions = {n.id: d for n, d in zip(split_nodes, decision_list)}
    axis_nodes = [n for n in graph
                  if n.op is not None and not n.splittable]
    axis_list = grid_axis_partition_batch(
        [n.op for n in axis_nodes], device, threads, mechanism=mechanism,
        seed=seed)
    decisions.update({n.id: d for n, d in zip(axis_nodes, axis_list)})
    return GraphPlanReport(device=device, threads=threads, baseline_us=0.0,
                           individual_us=0.0, end_to_end_us=0.0,
                           decisions=decisions, opaque_us={})
