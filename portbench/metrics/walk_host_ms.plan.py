"""Milliseconds of host time a traced request spent in the fused walk
outside its syncs: the `repro_torch.walk` span less the
`repro_torch.sync` spans inside it (dispatch, graph replays, the
records), averaged over the walks."""
from portbench import spans


def read(run):
    return spans.per_walk_ms(
        run, lambda walk, syncs: walk[1] - walk[0] - spans.length(syncs))
