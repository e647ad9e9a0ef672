"""Milliseconds a traced prefill call kept the card busy: the union of
the kernels', copies' and sets' intervals over the traced window, per
call (the traced calls take the prompt lengths in turn)."""


def read(run):
    if run.trace is None or run.trace.calls <= 0:
        return None
    busy = run.trace.busy_s()
    return 1e3 * busy / run.trace.calls if busy > 0 else None
