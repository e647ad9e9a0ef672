"""The traced slice of a run: calls under `torch.profiler`, read back from
the profiler's chrome trace.

The slice is wrapped in one `record_function` range (`WINDOW`); its
length on the trace's clock is the traced window.  Device operations are
the trace's kernels, copies and sets; host events are the CPU operators
and CUDA runtime and driver calls of the thread that ran the slice.  From
them:

- busy time: the union of the device operations' intervals on all
  streams, inside the window;
- overlap: the time in which two or more device operations run at once;
- a kernel's time: the union of its launches' intervals;
- host launches: the runtime and driver calls that put a kernel or a
  graph on the card;
- idle gaps: the window's time outside the busy union, each instant named
  by the innermost host event open at the gap's middle (`python` where
  none is: the interpreter between operators).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

#: the range around the traced slice
WINDOW = "portbench.window"
#: trace categories of device operations, and of host events
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: host calls that put a kernel or a graph on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")

Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    """Times in microseconds on the trace's clock."""

    device: List[Tuple[float, float, str]]     # (start, end, name)
    host: List[Tuple[float, float, str]]       # the slice's thread
    launches: int
    calls: int
    window: Interval

    @classmethod
    def from_events(cls, events: List[dict], calls: int) -> "Trace":
        spans = [e for e in events if e.get("ph") == "X"]
        marks = [e for e in spans if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError("the trace holds no traced window")
        mark = marks[0]
        w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in spans
                        if e.get("cat") in DEVICE_CATS)
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in spans
                      if e.get("cat") in HOST_CATS
                      and e.get("tid") == mark.get("tid") and e is not mark)
        launches = sum(1 for e in spans if e.get("cat") in
                       ("cuda_runtime", "cuda_driver")
                       and e["name"] in LAUNCH_CALLS)
        return cls(device, host, launches, calls, (w0, w1))

    # ---------------------------------------------------------- windows
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _clipped(self) -> List[Interval]:
        w0, w1 = self.window
        return [(max(s, w0), min(e, w1)) for s, e, _ in self.device
                if e > w0 and s < w1]

    def busy(self) -> List[Interval]:
        """The union of the device operations' intervals, in order."""
        return _union(self._clipped())

    def busy_s(self) -> float:
        return _union_s(self._clipped())

    def overlap_s(self) -> float:
        """Seconds in which two or more device operations run at once."""
        edges = sorted([(s, 1) for s, _ in self._clipped()]
                       + [(e, -1) for _, e in self._clipped()])
        depth, last, both = 0, 0.0, 0.0
        for t, step in edges:
            if depth >= 2:
                both += t - last
            depth += step
            last = t
        return both / 1e6

    # ---------------------------------------------------------- kernels
    def kernel_s(self, match: Callable[[str], bool]) -> float:
        """Seconds in which an operation whose name matches ran: the union
        of their intervals, so that two streams running the two sides of
        one split at once count that time once."""
        return _union_s([(s, e) for s, e, name in self.device
                         if match(name)])

    def top_ops(self, k: int = 10) -> List[List]:
        """The device operations that took most time: [name, seconds]."""
        by: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device:
            by[name] += (e - s) / 1e6
        return [[n, v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The window's idle time by what the host was doing: [host event,
        seconds], longest first."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        by: Dict[str, float] = defaultdict(float)
        for (s, e), name in zip(gaps, self._host_at([(s + e) / 2
                                                     for s, e in gaps])):
            by[name] += (e - s) / 1e6
        return [[n, v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def _host_at(self, instants: List[float]) -> List[str]:
        """The innermost host event open at each instant (host events of
        one thread nest), by a sweep in time order."""
        order = sorted(range(len(instants)), key=instants.__getitem__)
        events = sorted(self.host, key=lambda ev: (ev[0], -ev[1]))
        starts = [ev[0] for ev in events]
        names = ["python"] * len(instants)
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for i in order:
            t = instants[i]
            upto = bisect.bisect_right(starts, t)
            while j < upto:
                ev = events[j]
                while stack and stack[-1][1] <= ev[0]:
                    stack.pop()
                stack.append(ev)
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack:
                names[i] = stack[-1][2]
        return names


def _union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union_s(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in _union(intervals)) / 1e6


def profile(call: Callable[[int], object], first: int, calls: int,
            sync: Callable[[], None]) -> Trace:
    """Calls `first` .. `first + calls - 1` under the profiler, the device
    synchronised before and after, read back into a `Trace`."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(first, first + calls):
                call(i)
            sync()
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace.from_events(events, calls)
