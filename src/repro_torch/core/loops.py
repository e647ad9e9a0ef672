"""`counted_range(n)`: the loop of a body whose iterations have equal
shapes and carry only their state, the port's counterpart of a
`lax.scan` with a known trip count.

Outside a cost walk it is `range(n)`.  A walk (`roofline.op_walk`)
installs itself here with `weighing(walker)`; `counted_range` then runs
iteration 0 as it is and iteration 1 under `walker.weighted(n - 1)`, and
stops, so the walk counts the whole loop from two bodies.  How a body is
weighed is the walker's business: it has a `weight`, 1.0 outside any
weighed body, and a `weighted(n)` context manager.  A counted loop inside
a weighed body runs in full, weighed by the outer one.  A walk takes
fake tensors only, so no value anyone reads comes from a collapsed loop.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

_WALKER: contextvars.ContextVar = contextvars.ContextVar(
    "counted_range_walker", default=None)


@contextlib.contextmanager
def weighing(walker):
    """Collapse every `counted_range` run inside the block into two
    bodies weighed by `walker`."""
    token = _WALKER.set(walker)
    try:
        yield walker
    finally:
        _WALKER.reset(token)


def counted_range(n: int) -> Iterator[int]:
    """`range(n)` outside a walk (and inside a weighed body); inside one,
    iterations 0 and 1, the second weighed by n - 1."""
    walker = _WALKER.get()
    if walker is None or n <= 2 or walker.weight != 1.0:
        yield from range(n)
        return
    yield 0
    with walker.weighted(n - 1):
        yield 1
