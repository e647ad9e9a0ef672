"""CPU-GPU synchronization cost models (paper Section 4).

Two mechanisms:

  * EVENT — the baseline: the CPU passively waits on GPU kernel completion
    via clWaitForEvents-style notification, plus map/unmap of coarse-grained
    shared buffers for cache coherence.  Mean delay ~150-160 us.
  * SVM_POLL — the paper's contribution: layer outputs live in fine-grained
    shared virtual memory (hardware cache coherence, no map/unmap) and both
    sides busy-poll `cpu_flag`/`gpu_flag`.  Mean overhead ~7 us.

The port's copy of `repro.core.sync` (less its TPU all-gather price,
which nothing in the port charges): the planner charges these
simulated-phone costs whatever device later runs the plan.
"""
from __future__ import annotations

import enum

from repro_torch.core.simulator.devices import DEVICES


class SyncMechanism(str, enum.Enum):
    EVENT = "event"          # clWaitForEvents + buffer map/unmap
    SVM_POLL = "svm_poll"    # fine-grained SVM + active polling


def sync_overhead_us(device: str, mechanism: SyncMechanism) -> float:
    """Mean synchronization overhead charged to a co-execution strategy.

    Exclusive execution (all channels on one device) pays no overhead; the
    partitioner applies that rule (T_overhead(c1, c2) = 0 at the borders).
    """
    dev = DEVICES[device]
    if mechanism == SyncMechanism.EVENT:
        return dev.sync_event_us
    return dev.sync_svm_us

