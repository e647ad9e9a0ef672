"""Output-channel workload partitioning (paper Section 2).

Solves   min_{c1+c2=C_out}  T_overhead(c1,c2) + max(T_CPU(c1), T_GPU(c2))

over a channel grid, where the latency terms come either from trained
predictors (the deployable path — "3-4 ms per operation, offline") or from
noisy measurements (the grid-search oracle the paper uses as its upper
bound, Table 2).

Planning is vectorized: the `*_batch` functions featurize and score every
candidate split of every op in a handful of batched
`LatencyPredictor.predict` / `measure_latency_us_batch` calls, and the
single-op entry points are thin wrappers over them.  Decisions are
bit-identical to scoring each candidate in its own call — predictions and
measurements are per-row, so batch composition cannot change the argmin.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.predictor.train import LatencyPredictor
from repro_torch.core.simulator.measure import measure_latency_us_batch
from repro_torch.core.sync import SyncMechanism, sync_overhead_us
from repro_torch.core.types import Op
from repro_torch.kernels import registry


@dataclasses.dataclass(frozen=True)
class PartitionDecision:
    op: Op
    c_cpu: int
    c_gpu: int
    pred_cpu_us: float
    pred_gpu_us: float
    pred_total_us: float
    #: partition axis: "channel" (the paper's conv/linear domain, where
    #: c_cpu/c_gpu count output channels), "head" / "kv-block" /
    #: "ssm-state" (typed axes, where they count axis units — heads or
    #: cache positions), or "none" (exclusive placement of an axis kind)
    axis: str = "channel"
    #: autotuned TPU tile config the plan carries (data only: no Hopper
    #: kernel applies it); None means the kind's default blocking and keeps
    #: pre-tile plan JSON byte-identical
    tile: Optional[registry.TileConfig] = None

    @property
    def exclusive(self) -> bool:
        return self.c_cpu == 0 or self.c_gpu == 0


def _candidate_splits(c_out: int, step: int) -> np.ndarray:
    cands = np.arange(0, c_out + 1, step)
    if cands[-1] != c_out:
        cands = np.append(cands, c_out)
    return cands


def _candidate_grid(ops: Sequence[Op], step: int):
    """Flatten every op's candidate splits into one grid.

    Returns (gpu_ops, cpu_ops, c_gpu, c_cpu, spans) where spans[i] is the
    half-open [lo, hi) slice of op i's candidates in the flat arrays.
    """
    gpu_ops: List[Op] = []
    cpu_ops: List[Op] = []
    c_gpu_parts: List[np.ndarray] = []
    c_cpu_parts: List[np.ndarray] = []
    spans: List[Tuple[int, int]] = []
    for op in ops:
        c_gpu = _candidate_splits(op.C_out, step)
        c_cpu = op.C_out - c_gpu
        spans.append((len(gpu_ops), len(gpu_ops) + len(c_gpu)))
        gpu_ops.extend(op.with_cout(int(c)) for c in c_gpu)
        cpu_ops.extend(op.with_cout(int(c)) for c in c_cpu)
        c_gpu_parts.append(c_gpu)
        c_cpu_parts.append(c_cpu)
    c_gpu_all = np.concatenate(c_gpu_parts) if c_gpu_parts else np.empty(0, int)
    c_cpu_all = np.concatenate(c_cpu_parts) if c_cpu_parts else np.empty(0, int)
    return gpu_ops, cpu_ops, c_gpu_all, c_cpu_all, spans


def _decide(ops: Sequence[Op], t_gpu: np.ndarray, t_cpu: np.ndarray,
            c_gpu: np.ndarray, c_cpu: np.ndarray, spans, overhead: float
            ) -> List[PartitionDecision]:
    coexec = (c_gpu > 0) & (c_cpu > 0)
    total = np.maximum(t_cpu, t_gpu) + np.where(coexec, overhead, 0.0)
    decisions = []
    for op, (lo, hi) in zip(ops, spans):
        i = lo + int(np.argmin(total[lo:hi]))
        decisions.append(PartitionDecision(
            op=op, c_cpu=int(c_cpu[i]), c_gpu=int(c_gpu[i]),
            pred_cpu_us=float(t_cpu[i]), pred_gpu_us=float(t_gpu[i]),
            pred_total_us=float(total[i])))
    return decisions


def optimal_partition_batch(ops: Sequence[Op], cpu_pred: LatencyPredictor,
                            gpu_pred: LatencyPredictor, *,
                            mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                            step: int = 8) -> List[PartitionDecision]:
    """Predictor-driven partitioning of many ops in two `predict` calls."""
    ops = list(ops)
    if not ops:
        return []
    device = gpu_pred.device
    overhead = sync_overhead_us(device, mechanism)
    gpu_ops, cpu_ops, c_gpu, c_cpu, spans = _candidate_grid(ops, step)
    t_gpu = np.where(c_gpu > 0, gpu_pred.predict(gpu_ops), 0.0)
    t_cpu = np.where(c_cpu > 0, cpu_pred.predict(cpu_ops), 0.0)
    return _decide(ops, t_gpu, t_cpu, c_gpu, c_cpu, spans, overhead)


def optimal_partition(op: Op, cpu_pred: LatencyPredictor,
                      gpu_pred: LatencyPredictor, *,
                      mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                      step: int = 8) -> PartitionDecision:
    """Predictor-driven partitioning (the paper's deployable method)."""
    return optimal_partition_batch([op], cpu_pred, gpu_pred,
                                   mechanism=mechanism, step=step)[0]


def grid_search_partition_batch(ops: Sequence[Op], device: str, threads: int,
                                *,
                                mechanism: SyncMechanism =
                                SyncMechanism.SVM_POLL,
                                step: int = 8, seed: int = 0
                                ) -> List[PartitionDecision]:
    """Measurement-driven exhaustive search over many ops in two batched
    measurement calls (zero-channel candidates measure as exactly 0)."""
    ops = list(ops)
    if not ops:
        return []
    overhead = sync_overhead_us(device, mechanism)
    gpu_ops, cpu_ops, c_gpu, c_cpu, spans = _candidate_grid(ops, step)
    t_gpu = measure_latency_us_batch(gpu_ops, device, "gpu", seed=seed)
    t_cpu = measure_latency_us_batch(cpu_ops, device, f"cpu{threads}",
                                     seed=seed)
    return _decide(ops, t_gpu, t_cpu, c_gpu, c_cpu, spans, overhead)


def grid_search_partition(op: Op, device: str, threads: int, *,
                          mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                          step: int = 8, seed: int = 0) -> PartitionDecision:
    """Measurement-driven exhaustive search (the paper's oracle baseline;
    step 8 matches Section 5.3)."""
    return grid_search_partition_batch([op], device, threads,
                                       mechanism=mechanism, step=step,
                                       seed=seed)[0]


def realized_latency_us_batch(decisions: Sequence[PartitionDecision],
                              device: str, threads: int, *,
                              mechanism: SyncMechanism =
                              SyncMechanism.SVM_POLL,
                              seed: int = 1) -> np.ndarray:
    """Measured co-execution latencies of many decisions (fresh measurement
    seed, so predictor-driven decisions are scored on unseen noise)."""
    decisions = list(decisions)
    if not decisions:
        return np.empty(0)
    gpu_ops = [d.op.with_cout(d.c_gpu) for d in decisions]
    cpu_ops = [d.op.with_cout(d.c_cpu) for d in decisions]
    t_gpu = measure_latency_us_batch(gpu_ops, device, "gpu", seed=seed)
    t_cpu = measure_latency_us_batch(cpu_ops, device, f"cpu{threads}",
                                     seed=seed)
    overhead = sync_overhead_us(device, mechanism)
    exclusive = np.array([d.exclusive for d in decisions])
    return np.maximum(t_cpu, t_gpu) + np.where(exclusive, 0.0, overhead)


def realized_latency_us(decision: PartitionDecision, device: str,
                        threads: int, *,
                        mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                        seed: int = 1) -> float:
    """Measured co-execution latency of a decision."""
    return float(realized_latency_us_batch([decision], device, threads,
                                           mechanism=mechanism, seed=seed)[0])


def speedup_vs_gpu_batch(decisions: Sequence[PartitionDecision], device: str,
                         threads: int, *,
                         mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                         seed: int = 1) -> np.ndarray:
    """Paper's metric, batched: speedup of co-execution over GPU-only."""
    decisions = list(decisions)
    if not decisions:
        return np.empty(0)
    gpu_only = measure_latency_us_batch([d.op for d in decisions], device,
                                        "gpu", seed=seed)
    co = realized_latency_us_batch(decisions, device, threads,
                                   mechanism=mechanism, seed=seed)
    return gpu_only / co


def speedup_vs_gpu(decision: PartitionDecision, device: str, threads: int, *,
                   mechanism: SyncMechanism = SyncMechanism.SVM_POLL,
                   seed: int = 1) -> float:
    """Paper's metric: speedup of co-execution over GPU-only execution."""
    return float(speedup_vs_gpu_batch([decision], device, threads,
                                      mechanism=mechanism, seed=seed)[0])


# ------------------------------------------------------ typed-axis splits
#
# Attention and SSM decode ops partition along registry-typed axes (head /
# kv-block / ssm-state) instead of output channels, and additionally carry
# a kernel *mode* the planner chooses.  The same batched two-predict-call
# structure applies: every (axis, boundary, mode) candidate of every op is
# flattened into one GPU list and one CPU list.

def _axis_candidate_grid(ops: Sequence[Op]):
    """Flatten every op's (axis, boundary, mode) candidates.

    Returns (gpu_ops, cpu_ops, n_gpu, n_cpu, axes, extra_bytes, spans).
    Zero-unit sides are represented by the *full* op (these kinds cannot
    encode an empty sub-op) and masked to zero latency by the callers;
    exclusive placements are labeled axis="none" with unit counts 1/0.
    ``extra_bytes`` carries the kv-block merge traffic (partial outputs
    from both sides are combined with a log-sum-exp pass).
    """
    gpu_ops: List[Op] = []
    cpu_ops: List[Op] = []
    n_gpu: List[int] = []
    n_cpu: List[int] = []
    axes: List[str] = []
    extra: List[float] = []
    spans: List[Tuple[int, int]] = []
    for op in ops:
        entry = registry.entry_for(op)
        modes = entry.modes or ("",)
        lo = len(gpu_ops)
        for mode in modes:
            opm = op.with_mode(mode) if entry.modes else op
            for side_gpu in (1, 0):
                gpu_ops.append(opm)
                cpu_ops.append(opm)
                n_gpu.append(side_gpu)
                n_cpu.append(1 - side_gpu)
                axes.append("none")
                extra.append(0.0)
            for spec in registry.axes_for(opm):
                size, g = spec.size(opm), spec.granularity(opm)
                for n in range(g, size, g):
                    registry.validate_axis_split(opm, spec.axis, n)
                    gpu_ops.append(spec.sub(opm, n))
                    cpu_ops.append(spec.sub(opm, size - n))
                    n_gpu.append(n)
                    n_cpu.append(size - n)
                    axes.append(spec.axis)
                    extra.append(2.0 * opm.output_bytes
                                 if not spec.stackable else 0.0)
        spans.append((lo, len(gpu_ops)))
    return (gpu_ops, cpu_ops, np.asarray(n_gpu), np.asarray(n_cpu),
            axes, np.asarray(extra), spans)


def _axis_decide(ops: Sequence[Op], gpu_ops: Sequence[Op],
                 t_gpu: np.ndarray, t_cpu: np.ndarray,
                 n_gpu: np.ndarray, n_cpu: np.ndarray, axes: Sequence[str],
                 extra_bytes: np.ndarray, spans, device: str,
                 overhead: float) -> List[PartitionDecision]:
    from repro_torch.core.simulator.devices import DEVICES
    dev = DEVICES[device]
    coexec = (n_gpu > 0) & (n_cpu > 0)
    # Non-stackable axes (extra_bytes > 0, i.e. kv-block) materialize a
    # log-sum-exp merge of both sides' partials: besides the merge traffic
    # itself they pay a second sync rendezvous, and cannot amortize it by
    # chaining into a fused segment.
    merge_us = extra_bytes / (dev.cpu_mem_gbps * 1e3)
    merge_us = merge_us + np.where(extra_bytes > 0.0, overhead, 0.0)
    total = (np.maximum(t_cpu, t_gpu)
             + np.where(coexec, overhead + merge_us, 0.0))
    decisions = []
    for op, (lo, hi) in zip(ops, spans):
        i = lo + int(np.argmin(total[lo:hi]))
        chosen = gpu_ops[i]                 # carries the winning mode
        entry = registry.entry_for(op)
        full = op.with_mode(chosen.mode) if entry.modes else op
        decisions.append(PartitionDecision(
            op=full, c_cpu=int(n_cpu[i]), c_gpu=int(n_gpu[i]),
            pred_cpu_us=float(t_cpu[i]), pred_gpu_us=float(t_gpu[i]),
            pred_total_us=float(total[i]), axis=axes[i]))
    return decisions


def axis_partition_batch(ops: Sequence[Op], cpu_pred: LatencyPredictor,
                         gpu_pred: LatencyPredictor, *,
                         mechanism: SyncMechanism = SyncMechanism.SVM_POLL
                         ) -> List[PartitionDecision]:
    """Predictor-driven (axis, boundary, mode) partitioning of many
    attention/SSM ops in two batched `predict` calls."""
    ops = list(ops)
    if not ops:
        return []
    device = gpu_pred.device
    overhead = sync_overhead_us(device, mechanism)
    (gpu_ops, cpu_ops, n_gpu, n_cpu, axes, extra,
     spans) = _axis_candidate_grid(ops)
    t_gpu = np.where(n_gpu > 0, gpu_pred.predict(gpu_ops), 0.0)
    t_cpu = np.where(n_cpu > 0, cpu_pred.predict(cpu_ops), 0.0)
    return _axis_decide(ops, gpu_ops, t_gpu, t_cpu, n_gpu, n_cpu, axes,
                        extra, spans, device, overhead)


def grid_axis_partition_batch(ops: Sequence[Op], device: str, threads: int,
                              *,
                              mechanism: SyncMechanism =
                              SyncMechanism.SVM_POLL,
                              seed: int = 0) -> List[PartitionDecision]:
    """Measurement-driven exhaustive (axis, boundary, mode) search."""
    ops = list(ops)
    if not ops:
        return []
    overhead = sync_overhead_us(device, mechanism)
    (gpu_ops, cpu_ops, n_gpu, n_cpu, axes, extra,
     spans) = _axis_candidate_grid(ops)
    t_gpu = np.where(n_gpu > 0,
                     measure_latency_us_batch(gpu_ops, device, "gpu",
                                              seed=seed), 0.0)
    t_cpu = np.where(n_cpu > 0,
                     measure_latency_us_batch(cpu_ops, device,
                                              f"cpu{threads}", seed=seed),
                     0.0)
    return _axis_decide(ops, gpu_ops, t_gpu, t_cpu, n_gpu, n_cpu, axes,
                        extra, spans, device, overhead)


def axis_side_ops(decision: PartitionDecision) -> Tuple[Op, Op]:
    """(gpu_sub_op, cpu_sub_op) of a typed-axis decision; exclusive
    decisions return the full op for the placed side (the other entry is
    the full op too — callers mask by the zero unit count)."""
    op = decision.op
    if decision.exclusive or decision.axis in ("none", "channel"):
        return op, op
    spec = registry.axis_spec(registry.op_kind(op), decision.axis)
    return (spec.sub(op, decision.c_gpu), spec.sub(op, decision.c_cpu))


def axis_realized_latency_us_batch(decisions: Sequence[PartitionDecision],
                                   device: str, threads: int, *,
                                   mechanism: SyncMechanism =
                                   SyncMechanism.SVM_POLL,
                                   seed: int = 1) -> np.ndarray:
    """Measured latencies of typed-axis decisions (fresh noise seed)."""
    decisions = list(decisions)
    if not decisions:
        return np.empty(0)
    sides = [axis_side_ops(d) for d in decisions]
    t_gpu = measure_latency_us_batch([g for g, _ in sides], device, "gpu",
                                     seed=seed)
    t_cpu = measure_latency_us_batch([c for _, c in sides], device,
                                     f"cpu{threads}", seed=seed)
    n_gpu = np.array([d.c_gpu for d in decisions])
    n_cpu = np.array([d.c_cpu for d in decisions])
    t_gpu = np.where(n_gpu > 0, t_gpu, 0.0)
    t_cpu = np.where(n_cpu > 0, t_cpu, 0.0)
    overhead = sync_overhead_us(device, mechanism)
    exclusive = np.array([d.exclusive for d in decisions])
    return np.maximum(t_cpu, t_gpu) + np.where(exclusive, 0.0, overhead)
