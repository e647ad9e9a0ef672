"""% of the plan's linear nodes' least time (2 L C_in C_out operations;
x, W and y moved once, fp32) over the time in which `split_matmul`'s
kernels ran, over the traced requests."""
from portbench import readers


def read(run):
    return readers.roofline_share(run, ("linear",),
                                  readers.SPLIT_MATMUL.search)
