"""Milliseconds a traced request's card sat idle after its walk drained
it: for each `repro_torch.sync` of a walk but its last, the time from the
sync's end to the next device operation's start (clipped to the walk's
end), summed, averaged over the walks."""
from portbench import spans


def read(run):
    return spans.per_walk_ms(
        run, lambda walk, syncs: spans.refill_us(run.trace, walk, syncs))
