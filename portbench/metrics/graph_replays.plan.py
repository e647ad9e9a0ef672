"""CUDA graph replays a traced request's walk made: the
`repro_torch.replay` spans inside each `repro_torch.walk` span, averaged
over the walks.  None where the run has no walk, or where no replay span
was traced (a program built before the span, or one that captured
nothing)."""
from portbench import spans

REPLAY = "repro_torch.replay"


def read(run):
    found = spans.walks(run)
    replays = spans.named(run.trace, REPLAY.__eq__) if found else []
    if not replays:
        return None
    return sum(sum(1 for s, e in replays if w0 <= s and e <= w1)
               for (w0, w1), _ in found) / len(found)
