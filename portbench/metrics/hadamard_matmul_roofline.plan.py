"""% of the Winograd-domain products' least time (16 products (P, C_in) @
(C_in, C_out) for each F(2x2, 3x3) conv; U, V and M moved once, fp32) over
the time in which `hadamard_matmul`'s kernel ran, over the traced
requests."""
from portbench import readers


def read(run):
    return readers.roofline_share(run, ("hadamard",),
                                  readers.HADAMARD_MATMUL.search)
