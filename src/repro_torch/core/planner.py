"""The planner's report, as data.

The port's copy of `repro.core.planner.PlanReport`: what a compiled plan
records about its planning (the all-GPU baseline, the sum of isolated
co-executed latencies, the end-to-end schedule latency) beside its
decisions.  `CoexecPlan.report()` rebuilds it from a plan document.  The
planner itself (`plan_network`, `plan_graph`) stays in the JAX package
until the port's planning half.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from repro_torch.runtime.plan import PartitionDecision


@dataclasses.dataclass
class PlanReport:
    device: str
    threads: int
    baseline_us: float          # all-GPU
    individual_us: float        # sum of isolated co-exec latencies
    end_to_end_us: float        # schedule incl. boundary costs
    decisions: List["PartitionDecision"]

    @property
    def individual_speedup(self) -> float:
        return self.baseline_us / self.individual_us

    @property
    def end_to_end_speedup(self) -> float:
        return self.baseline_us / self.end_to_end_us
