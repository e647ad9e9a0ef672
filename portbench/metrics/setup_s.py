"""Seconds from the process's start to the first timed call: loading,
weights, kernel builds (the first run in a checkout), warm-up."""


def read(run):
    return run.setup_s
