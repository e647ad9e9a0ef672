"""% of the prefill scans' least time (`counts_zamba2.ssd_call`: one
`ssd_chunk_scan` call a group and layer, 4 P N operations per token and
head; x, B, C and y moved once at 2 bytes, dt, a and the states at 4)
over the time in which the SSD chunk kernels (`ssd_chunk_state`,
`ssd_chunk_pass`, `ssd_chunk_out`) ran, over the traced calls."""
import re

from portbench import readers

SSD_CHUNK = re.compile(r"\bssd_chunk_(state|pass|out)<")


def read(run):
    return readers.roofline_share(run, ("ssd",), SSD_CHUNK.search)
