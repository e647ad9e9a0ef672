"""The readers of the program's spans (`portbench/spans.py`): on a
hand-made chrome trace with known values, on a trace without the spans
(a program built before them), and on a CPU traced run of a small
plan."""
import math
import types

import pytest

from portbench import manifest, run
from portbench.trace import WINDOW, Trace

DOC = manifest.load()
CELL = manifest.cell(DOC, "vgg16.coexec-b1")
SPAN_METRICS = ("walk_host_ms.plan", "sync_wait_ms.plan",
                "sync_refill_ms.plan", "split_overlap.plan")


def _x(cat, name, ts, end, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "tid": tid}


def _span(name, ts, end):
    return _x("user_annotation", name, ts, end)


def _segment(k, kind, ids, ts, end, sync, records):
    return [_span(f"repro_torch.segment[{k}] {kind} {ids}", ts, end),
            _span("repro_torch.sync", *sync),
            _span("repro_torch.records", *records)]


#: two walks.  Walk 1 [10, 400]: syncs of 30, 50 and 30 us; the card
#: refills 50 us after the first (kernel a at 130) and 70 after the second
#: (kernel p at 320); its last sync is left out.  Its fused segment
#: [100, 300] holds kernels a and b, 80 us at once in a union of 110.
#: Walk 2 [500, 900]: syncs of 50, 80 and 3 us; refills of 70 (kernel e at
#: 720) and 20 (the next kernel, at 950, lies past the walk's end at 900).
#: Its fused segment [505, 700] clips kernel c to [505, 620]: 40 us of d
#: at once in a union of 115.
EVENTS = [
    _span(WINDOW, 0, 1000),
    _span("repro_torch.walk", 10, 400),
    *_segment(0, "exclusive", "n0..n0", 12, 100, (50, 80), (82, 95)),
    _x("cpu_op", "aten::cudnn_convolution", 15, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 16, 20),
    *_segment(1, "fused", "n1..n2", 100, 300, (200, 250), (255, 290)),
    _x("cuda_runtime", "cudaGraphLaunch", 110, 120),
    *_segment(2, "pool", "n3..n3", 300, 398, (350, 380), (385, 395)),
    _span("repro_torch.walk", 500, 900),
    *_segment(0, "fused", "n0..n1", 505, 700, (600, 650), (660, 690)),
    *_segment(1, "exclusive", "n2..n2", 700, 890, (800, 880), (882, 888)),
    *_segment(2, "pool", "n3..n3", 890, 899, (892, 895), (896, 898)),
    _x("user_annotation", "repro_torch.walk", 0, 1000, tid=2),
    _x("kernel", "k0", 20, 78),
    _x("kernel", "a", 130, 230),
    _x("kernel", "b", 150, 240),
    _x("kernel", "p", 320, 360),
    _x("kernel", "c", 500, 620),
    _x("gpu_memcpy", "d", 520, 560),
    _x("kernel", "e", 720, 870),
    _x("gpu_memset", "after", 950, 990),
    _x("gpu_user_annotation", "repro_torch.walk", 20, 990),
]

EXPECTED = {
    # (390 - 110 + 400 - 133) / 2 us
    "walk_host_ms.plan": 273.5e-3,
    # (110 + 133) / 2 us
    "sync_wait_ms.plan": 121.5e-3,
    # (50 + 70 + 70 + 20) / 2 us
    "sync_refill_ms.plan": 105e-3,
    # (80 + 40) / (110 + 115)
    "split_overlap.plan": 100.0 * 120 / 225,
}


def _read(name, events):
    trace = None if events is None else Trace.from_events(events, calls=2)
    return manifest.reader(name).read(types.SimpleNamespace(trace=trace))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_known_values_on_a_hand_made_trace(name):
    assert _read(name, EVENTS) == pytest.approx(EXPECTED[name])


def _without(events, match):
    return [e for e in events if not (e.get("cat") == "user_annotation"
                                      and match(e["name"]))]


@pytest.mark.parametrize("name", SPAN_METRICS)
@pytest.mark.parametrize("case", ["no spans", "no walk", "not traced"])
def test_none_without_a_walk(name, case):
    events = {"no spans": _without(EVENTS,
                                   lambda n: n.startswith("repro_torch.")),
              "no walk": _without(EVENTS, "repro_torch.walk".__eq__),
              "not traced": None}[case]
    assert _read(name, events) is None


def test_split_overlap_is_none_without_a_fused_segment():
    events = [dict(e, name=e["name"].replace(" fused ", " exclusive "))
              for e in EVENTS]
    assert _read("split_overlap.plan", events) is None
    assert _read("walk_host_ms.plan", events) == \
        pytest.approx(EXPECTED["walk_host_ms.plan"])


@pytest.mark.parametrize("entry", [m for m in DOC["per_layer"]
                                   if m["name"] in SPAN_METRICS],
                         ids=lambda m: m["name"])
def test_the_manifest_entries(entry):
    assert entry["source"] == "program_span"
    assert entry["moves"] == "plan_requests_per_s"
    assert entry["workloads"] == ["vgg16.coexec-b1"]
    assert entry["layer"] == ("Co-execution"
                              if entry["name"] == "split_overlap.plan"
                              else "Executor walk")


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    """A VGG-like chain at 32x32: a split conv, a Winograd conv, two max
    pools and two linear layers."""
    import repro_torch
    from repro_torch.core.types import ConvOp, LinearOp

    d = tmp_path_factory.mktemp("plan")
    units = [("conv", ConvOp(32, 32, 3, 32, 3, 1)),
             ("conv", ConvOp(32, 32, 32, 128, 3, 1)),
             ("pool", 4 * 16 * 16 * 128),
             ("conv", ConvOp(16, 16, 128, 64, 3, 1)),
             ("pool", 4 * 8 * 8 * 64),
             ("linear", LinearOp(1, 8 * 8 * 64, 256)),
             ("linear", LinearOp(1, 256, 10))]
    compiled = repro_torch.compile(
        units, repro_torch.Target(device="moto2022", threads=1),
        samples=120, estimators=25, cache=d / "plans",
        predictor_cache=d / "predictors")
    compiled.save(d / "tiny.coexec.json")
    return {"name": "tiny", "driver": "plan", "artifact": "tiny.coexec.json",
            "dir": str(d), "dtype": "float32", "tf32": False}


def test_a_cpu_traced_run_reads_the_walk(config):
    mix = {"batch": 1, "pool": 3, "trace_calls": 3, "check_calls": 4}
    res = run.execute(DOC, CELL, 2**31 + 29, 0.3, True, "cpu",
                      config=config, mix=mix, limits={"out_err": 1e-4})
    assert res["correct"], res["checks"]
    for name in ("walk_host_ms.plan", "sync_wait_ms.plan"):
        assert math.isfinite(res["metrics"][name]["value"])
        assert res["metrics"][name]["value"] > 0.0
