"""Kernel and graph launches the host made per traced call (the
profiler's CUDA runtime and driver calls)."""
from portbench import readers


def read(run):
    return readers.host_launches(run)
