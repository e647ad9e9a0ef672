"""% of the card's bf16 peak that the window's completed prefill calls'
model FLOPs make over the window (`counts_zamba2.prefill_call`: the
projections, causal attention, the scan's recurrence, the conv and the
last position's lm_head)."""
from portbench import counts


def read(run):
    done = run.completed()
    if not done or run.window_s <= 0.0:
        return None
    flops = sum(counts.total(run.driver.work(c.i)["model"]).flops
                for c in done)
    return 100.0 * flops / (run.window_s * run.compute_peak())
