"""% of the card's TF32 peak that the plan's FLOPs per request (its
convolutions, pools and products) make at the window's request rate."""
from portbench import readers


def read(run):
    return readers.mfu(run)
