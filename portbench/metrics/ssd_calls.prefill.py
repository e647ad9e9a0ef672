"""`ssd_chunk_scan` calls a traced prefill made (the model's
`last_prefill_counts["ssd_calls"]`: one a group and layer)."""


def read(run):
    calls = [t["counters"]["ssd_calls"] for t in run.traced
             if "ssd_calls" in t["counters"]]
    return sum(calls) / len(calls) if calls else None
