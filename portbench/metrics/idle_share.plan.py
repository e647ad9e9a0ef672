"""% of the traced window in which no operation ran on the card: one
minus the union of the kernels', copies' and sets' intervals on all
streams over the window."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
