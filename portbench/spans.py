"""The program's own spans in the traced slice, set against the device
operations on the trace's one clock.

The port's fused walk (`PlanExecutor._execute_fused`) opens, while the
profiler runs, one `repro_torch.walk` span per request; in it one span per
segment (`repro_torch.segment[<k>] <kind> <first>..<last>`), and in each
segment its `repro_torch.sync` and then its `repro_torch.records`.  They
are `user_annotation` events of the slice's thread (`Trace.host`).  A
program without them (a build before the spans) gives no walk, and every
reader returns None.
"""
from __future__ import annotations

import bisect
import re
from typing import Callable, List, Optional, Tuple

from portbench.trace import _union

WALK = "repro_torch.walk"
SYNC = "repro_torch.sync"
#: a fused segment's span: the paper's channel split runs in it
FUSED_SEGMENT = re.compile(r"^repro_torch\.segment\[\d+\] fused ")

Interval = Tuple[float, float]


def named(trace, match: Callable[[str], bool]) -> List[Interval]:
    """The host spans whose name `match` accepts, in time order (us)."""
    return [(s, e) for s, e, name in trace.host if match(name)]


def walks(run) -> List[Tuple[Interval, List[Interval]]]:
    """Each walk span of the traced slice with the sync spans inside it;
    empty where the run was not traced or the program has no spans."""
    if run.trace is None:
        return []
    syncs = named(run.trace, SYNC.__eq__)
    return [((w0, w1), [(s, e) for s, e in syncs if w0 <= s and e <= w1])
            for w0, w1 in named(run.trace, WALK.__eq__)]


def per_walk_ms(run, measure: Callable[[Interval, List[Interval]], float]
                ) -> Optional[float]:
    """The mean over the walks of `measure(walk, its syncs)`, us to ms."""
    found = walks(run)
    if not found:
        return None
    return sum(measure(w, syncs) for w, syncs in found) / len(found) / 1e3


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def refill_us(trace, walk: Interval, syncs: List[Interval]) -> float:
    """For each sync of a walk but its last, the time from its end to the
    start of the next device operation, clipped to the walk's end: the
    card's idle after each drain, until the host has dispatched again."""
    starts = [s for s, _, _ in trace.device]      # sorted by start
    total = 0.0
    for _, end in syncs[:-1]:
        i = bisect.bisect_left(starts, end)
        nxt = starts[i] if i < len(starts) else walk[1]
        total += min(nxt, walk[1]) - end
    return total


def overlap_share(trace, within: List[Interval]) -> Optional[float]:
    """% of the device operations' union, clipped to the intervals
    `within`, in which two or more of them ran at once; None where none
    ran there."""
    union = both = 0.0
    for w0, w1 in within:
        clipped = [(max(s, w0), min(e, w1)) for s, e, _ in trace.device
                   if e > w0 and s < w1]
        union += length(_union(clipped))
        both += _overlap_us(clipped)
    return 100.0 * both / union if union > 0.0 else None


def _overlap_us(intervals: List[Interval]) -> float:
    """Time in which two or more of the intervals are open."""
    edges = sorted([(s, 1) for s, _ in intervals]
                   + [(e, -1) for _, e in intervals])
    depth, last, both = 0, 0.0, 0.0
    for t, step in edges:
        if depth >= 2:
            both += t - last
        depth += step
        last = t
    return both
