"""Milliseconds a traced request's walk waited for the card: the
`repro_torch.sync` spans inside each `repro_torch.walk` span, summed,
averaged over the walks."""
from portbench import spans


def read(run):
    return spans.per_walk_ms(run, lambda walk, syncs: spans.length(syncs))
