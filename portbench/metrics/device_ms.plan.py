"""Milliseconds a traced request kept the card busy: the union of the
kernels', copies' and sets' intervals on all streams over the traced
window, per request.  The host does not pace it, so it moves with the
device work alone, where the request rate also moves with the host."""


def read(run):
    if run.trace is None or run.trace.calls <= 0:
        return None
    busy = run.trace.busy_s()
    return 1e3 * busy / run.trace.calls if busy > 0 else None
