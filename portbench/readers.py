"""What the metric readers share: the kernels' names and the shares of a
roofline, of a peak, and of the traced window.

A share of a roofline is the least time the card could take for the work
the configuration defines (`counts.py`, at the precision-matched peak of
`peaks.py`) over the time in which the kernels that did it ran (the union
of their intervals: the two sides of a split run at once), both over the
traced calls.  Where the trace holds none of those kernels the
reader returns None and the metric is left out: it never reads 0.
"""
from __future__ import annotations

import math
import re
from typing import Iterable, List, Optional

from portbench import counts

#: `split_matmul`'s kernels, by their names in the trace (a template's
#: name is followed by its arguments): the GEMV and its split-K
#: reduction (M <= 8), the tiled product and its reduction (M > 8)
SPLIT_MATMUL = re.compile(r"\b(splitk_gemv|splitk_reduce|splitk_reduce_rows"
                          r"|tc_gemm)<")
#: `hadamard_matmul`'s kernel, the Winograd-domain product
HADAMARD_MATMUL = re.compile(r"\bhadamard_gemm<")


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least q %
    of the values at or below it."""
    if not values:
        return math.nan
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q / 100.0 * len(ranked)) - 1)]


def traced_calls(run) -> range:
    return range(run.traced_first, run.traced_first + run.trace.calls)


def roofline_share(run, kinds: Iterable[str], match) -> Optional[float]:
    """% of the least time for the traced calls' work of `kinds` over the
    time in which the kernels `match` accepts ran."""
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s(match)
    if kernel_s <= 0.0:
        return None
    bound = sum(w.seconds(run.compute_peak(), run.memory_peak())
                for i in traced_calls(run)
                for kind in kinds for w in run.driver.work(i)[kind])
    return 100.0 * bound / kernel_s


def idle_share(run) -> Optional[float]:
    """% of the traced window in which no device operation ran."""
    if run.trace is None or run.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def host_launches(run) -> Optional[float]:
    """Kernel and graph launches the host made per traced call."""
    if run.trace is None:
        return None
    return run.trace.launches / run.trace.calls


def mfu(run) -> Optional[float]:
    """% of the compute peak that the window's completed calls' FLOPs (every
    kind of work a request is made of) make over the window."""
    done = run.completed()
    if not done or run.window_s <= 0.0:
        return None
    flops = sum(counts.total([w for kind in counts.STEP_KINDS
                              for w in run.driver.work(c.i)[kind]]).flops
                for c in done)
    return 100.0 * flops / (run.window_s * run.compute_peak())
