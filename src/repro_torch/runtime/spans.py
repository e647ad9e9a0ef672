"""Named spans of the port's host work, for `torch.profiler` traces.

`span(name)` is a `record_function` range while the profiler is on, so a
span shares the trace's clock with the kernels, copies and sets it
dispatched.  While the profiler is off it is one shared null context:
the cost is one attribute read, nothing is allocated.  The profiler's
trace is the only store; every span name starts with `repro_torch.`.
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler

#: what `span` returns while the profiler is off
NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name`, or `NULL` while nothing profiles."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return NULL
