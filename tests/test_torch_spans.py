"""The fused walk's profiler spans (`runtime/spans.py`), on the CPU.

A small compiled plan (a split conv, a Winograd conv, two max pools, two
linear layers) runs its fused walk under `torch.profiler`; the exported
chrome trace must hold one `repro_torch.walk` span per run, one segment
span per `SegmentProgram` in partition order, and in each segment span
one `repro_torch.sync` and, after it, one `repro_torch.records`.  A
segment span less its records times what `segment_wall_us` times.  With
the profiler off, `span` hands out the shared null context and builds no
`record_function`.
"""
import json
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch.core.types import ConvOp, LinearOp
from repro_torch.runtime import spans

RUNS = 2
WALK, SYNC, RECORDS = ("repro_torch.walk", "repro_torch.sync",
                       "repro_torch.records")
SEGMENT = re.compile(r"^repro_torch\.segment\[(\d+)\] (\w+) (\S+)\.\.(\S+)$")
#: chrome-trace timestamps are rounded to the nanosecond
EPS_US = 1e-2


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
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
    exe = compiled.executor(device="cpu")
    exe.run(fused=True, warmup=True)
    return exe


def _traced(exe, tmp_path, fused=True):
    """`RUNS` walks under the profiler: their reports and the trace's
    `repro_torch.` spans as (start, end, name), in time order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reports = [exe.run(fused=fused)[1] for _ in range(RUNS)]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("repro_torch."))
    return reports, marks


@pytest.fixture(scope="module")
def traced(exe, tmp_path_factory):
    return _traced(exe, tmp_path_factory.mktemp("trace"))


def _inside(marks, outer):
    s, e, _ = outer
    return [m for m in marks
            if m is not outer and m[0] >= s - EPS_US and m[1] <= e + EPS_US]


def _segments(marks, run):
    walk = [m for m in marks if m[2] == WALK][run]
    return [m for m in _inside(marks, walk) if SEGMENT.match(m[2])]


def test_one_walk_span_per_run(traced):
    reports, marks = traced
    walks = [m for m in marks if m[2] == WALK]
    assert len(walks) == len(reports) == RUNS
    # every other span lies in a walk
    assert all(any(w[0] <= m[0] and m[1] <= w[1] + EPS_US for w in walks)
               for m in marks)


@pytest.mark.parametrize("run", range(RUNS))
def test_a_segment_span_per_program_in_partition_order(exe, traced, run):
    _, marks = traced
    programs = exe.segment_programs()
    partition = exe.plan.segment_partition()
    names = [m[2] for m in _segments(marks, run)]
    assert names == [sp.span for sp in programs]
    for k, (name, seg) in enumerate(zip(names, partition)):
        index, kind, first, last = SEGMENT.match(name).groups()
        assert (int(index), kind, first, last) == \
            (k, seg.kind, seg.node_ids[0], seg.node_ids[-1])
    assert {sp.kind for sp in programs} >= {"fused", "pool", "exclusive"}


@pytest.mark.parametrize("run", range(RUNS))
def test_each_segment_holds_one_sync_then_its_records(traced, run):
    _, marks = traced
    for seg in _segments(marks, run):
        inner = _inside(marks, seg)
        assert [m[2] for m in inner] == [SYNC, RECORDS], seg[2]
        sync, records = inner
        assert records[0] >= sync[1]


@pytest.mark.parametrize("run", range(RUNS))
def test_a_segment_span_less_its_records_is_the_segment_wall(traced, run):
    reports, marks = traced
    walls = reports[run].segment_wall_us
    segments = _segments(marks, run)
    assert len(segments) == len(walls)
    for seg, wall in zip(segments, walls):
        (records,) = [m for m in _inside(marks, seg) if m[2] == RECORDS]
        timed = (seg[1] - seg[0]) - (records[1] - records[0])
        assert timed == pytest.approx(wall, rel=0.1, abs=50.0), seg[2]


def test_the_per_node_walk_has_no_spans(exe, tmp_path):
    _, marks = _traced(exe, tmp_path, fused=False)
    assert marks == []


@pytest.mark.parametrize("what", ["span", "fused walk"])
def test_off_the_profiler_no_record_function_is_built(exe, monkeypatch,
                                                      what):
    def refuse(*a, **k):
        raise AssertionError("record_function built with the profiler off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    if what == "span":
        assert spans.span("repro_torch.walk") is spans.NULL
        assert spans.span("repro_torch.sync") is spans.NULL
        with spans.span("repro_torch.walk"):
            pass
    else:
        y, report = exe.run(fused=True)
        assert report.fused and len(report.segment_wall_us) == \
            len(exe.segment_programs())


def test_while_profiling_a_span_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = spans.span("repro_torch.walk")
    assert isinstance(s, torch.autograd.profiler.record_function)
    assert spans.span("repro_torch.walk") is spans.NULL
