"""Host milliseconds a traced call spent in the shared-block applications
(`repro_torch.zamba2.shared` spans, each with its linear) inside the
engine's `repro_torch.prefill` spans, summed per prefill and averaged
over them.  None where the trace holds no prefill span."""
from portbench import spans

PREFILL = "repro_torch.prefill"
SHARED = "repro_torch.zamba2.shared"


def read(run):
    if run.trace is None:
        return None
    prefills = spans.named(run.trace, PREFILL.__eq__)
    if not prefills:
        return None
    shared = spans.named(run.trace, SHARED.__eq__)
    inside = [(s, e) for s, e in shared
              if any(p0 <= s and e <= p1 for p0, p1 in prefills)]
    return spans.length(inside) / len(prefills) / 1e3
