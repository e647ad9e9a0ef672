"""% of the card's busy time in the traced window in which two or more
device operations ran at once: what the co-execution split overlaps."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_s()
    return 100.0 * run.trace.overlap_s() / busy if busy > 0 else None
