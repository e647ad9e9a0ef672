"""Device syncs the executor's walk made per traced request
(`ExecutionReport.sync_points`, the program's counter)."""


def read(run):
    syncs = [t["counters"]["walk_syncs"] for t in run.traced
             if "walk_syncs" in t["counters"]]
    return sum(syncs) / len(syncs) if syncs else None
