"""Serving: the fixed-batch engine and the continuous scheduler.

The port's copies of `repro.serving` (`engine.py`, `scheduler.py`): the
models' prefill and decode run as PyTorch ops on the serving device, and
a shipped plan or plan portfolio executes through the port's
`PlanExecutor` on the hand-written kernels.
"""
from repro_torch.serving.engine import (Completion, Request, ServingEngine,
                                        sample_tokens)
from repro_torch.serving.scheduler import (ContinuousScheduler,
                                           FixedBatchReference, ReplanEvent,
                                           RequestStats, SchedulerConfig,
                                           SchedulerReport, ThrottleSim,
                                           poisson_requests)

__all__ = ["Completion", "ContinuousScheduler", "FixedBatchReference",
           "ReplanEvent", "Request", "RequestStats", "SchedulerConfig",
           "SchedulerReport", "ServingEngine", "ThrottleSim",
           "poisson_requests", "sample_tokens"]
