"""% of the traced window in which no operation ran on the card while the
prefill calls were served: one minus the union of the kernels', copies'
and sets' intervals over the window."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
