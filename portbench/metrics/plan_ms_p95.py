"""95th percentile of every window request's latency, in ms: host clock
from the call to its output, after the walk's last sync (a failed request
counts as missing every limit)."""
from portbench.readers import percentile


def read(run):
    return percentile(run.latencies_ms(), 95)
