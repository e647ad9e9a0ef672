"""Host milliseconds a traced call spent inside the engine's
`repro_torch.prefill` span (the model's prefill dispatched, no sync in
it), averaged over the spans.  None where the trace holds none (a program
built before the span)."""
from portbench import spans

PREFILL = "repro_torch.prefill"


def read(run):
    if run.trace is None:
        return None
    found = spans.named(run.trace, PREFILL.__eq__)
    return spans.length(found) / len(found) / 1e3 if found else None
