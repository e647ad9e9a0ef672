"""`graph_replays.plan`, the replay spans per walk, on hand-made chrome
traces: two walks with 17 and 4 replays, a trace without a walk, one
without replay spans (a program built before them), and no trace."""
import types

import pytest

from portbench import manifest
from portbench.trace import WINDOW, Trace

DOC = manifest.load()
NAME = "graph_replays.plan"


def _span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _walk(ts, replays):
    """A walk span at `ts` holding `replays` segments of 10 us, each with
    a replay span, then a sync."""
    events = [_span("repro_torch.walk", ts, ts + 10 * replays + 5)]
    for k in range(replays):
        t = ts + 1 + 10 * k
        events += [_span(f"repro_torch.segment[{k}] exclusive n{k}..n{k}",
                         t, t + 9),
                   _span("repro_torch.replay", t + 1, t + 4),
                   _span("repro_torch.sync", t + 5, t + 8)]
    return events


#: walks of 17 and 4 replays, a replay span outside any walk, another
#: thread's walk, and a device kernel
EVENTS = [_span(WINDOW, 0, 1000), *_walk(10, 17), *_walk(500, 4),
          _span("repro_torch.replay", 700, 705),
          _span("repro_torch.walk", 0, 1000, tid=2),
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 5,
           "tid": 7}]


def _read(events):
    trace = None if events is None else Trace.from_events(events, calls=2)
    return manifest.reader(NAME).read(types.SimpleNamespace(trace=trace))


def test_replays_per_walk():
    assert _read(EVENTS) == pytest.approx(10.5)


@pytest.mark.parametrize("case", ["no walk", "no replay span",
                                  "not traced"])
def test_none_without_a_walk_or_a_replay(case):
    drop = {"no walk": "repro_torch.walk",
            "no replay span": "repro_torch.replay"}.get(case)
    events = (None if case == "not traced" else
              [e for e in EVENTS if e["name"] != drop])
    assert _read(events) is None


def test_the_manifest_entry():
    (entry,) = [m for m in DOC["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "replays/request",
                     "better": "higher", "source": "program_span",
                     "layer": "Executor walk",
                     "moves": "plan_requests_per_s",
                     "workloads": ["vgg16.coexec-b1"]}
