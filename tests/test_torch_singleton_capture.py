"""The fused walk's captured singletons: pools and exclusive conv and
linear nodes run as CUDA graphs, like fused segments.

On the CPU the capture rule is held on the committed VGG16 plan, over
shapes only (the layout pass reads no weight; the plan is full size, so
none is drawn).  The tests marked `cuda` skip where there is no card; on
one they take the benchmark's frozen VGG16 plan
(`portbench/configs/vgg16.coexec.json`) and hold the captured walk to the
per-node walk: a graph for every pool and exclusive conv and linear
program, `torch.equal` outputs, a returned output left alone by the next
request, the per-node walk's kernel launches per request, and in every
captured segment's profiler span its `repro_torch.replay`, then its
`repro_torch.sync`, then its `repro_torch.records`.
"""
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch.graph.ir import (SEGMENT_EXCLUSIVE, SEGMENT_FUSED,
                                  SEGMENT_POOL)
from repro_torch.kernels import registry
from repro_torch.runtime.executor import PlanExecutor

from test_torch_segments import assert_capture_rule
from test_torch_spans import EPS_US, RECORDS, SEGMENT, SYNC, WALK, _inside
from test_torch_support import VGG16_ARTIFACT

ROOT = Path(__file__).resolve().parents[1]
FROZEN = ROOT / "portbench/configs/vgg16.coexec.json"
REPLAY = "repro_torch.replay"
#: VGG16's partition: 8 exclusive convs and linears, 5 pools, 4 fused runs
VGG16_KINDS = {SEGMENT_EXCLUSIVE: 8, SEGMENT_POOL: 5, SEGMENT_FUSED: 4}


def _kinds(programs):
    return {k: sum(p.kind == k for p in programs)
            for k in (SEGMENT_EXCLUSIVE, SEGMENT_POOL, SEGMENT_FUSED)}


def test_the_rule_on_the_committed_vgg16_plan(monkeypatch):
    # shapes only: no weight is drawn or loaded
    monkeypatch.setattr(registry.KernelEntry, "init_weight",
                        lambda self, op, rng: None)
    monkeypatch.setattr(PlanExecutor, "load_params",
                        lambda self, arrays: None)
    exe = repro_torch.CompiledNetwork.load(VGG16_ARTIFACT).executor(
        device="cpu")
    programs = assert_capture_rule(exe)
    assert _kinds(programs) == VGG16_KINDS
    assert all(p.captured for p in programs)


def test_the_frozen_plan_is_the_committed_one():
    assert json.loads(FROZEN.read_text())["plan"] == \
        json.loads(VGG16_ARTIFACT.read_text())["plan"]


# ------------------------------------------------------------------ card

@pytest.fixture(scope="module")
def card_exe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exe = repro_torch.CompiledNetwork.load(FROZEN).executor(device="cuda")
    exe.run(warmup=True)
    exe.run(fused=True, warmup=True)                  # captures
    return exe


def _inputs(exe, n):
    gen = torch.Generator(device=exe.device).manual_seed(31)
    shape = tuple(exe.input_template().shape)
    return [torch.randn(shape, generator=gen, device=exe.device)
            for _ in range(n)]


@pytest.mark.cuda
def test_every_pool_and_exclusive_conv_and_linear_is_a_graph(card_exe):
    programs = card_exe.segment_programs()
    assert _kinds(programs) == VGG16_KINDS
    for p in programs:
        assert p.graph is not None and p.static_output is not None, p.span
    assert all(len(p.static_inputs) == 1 for p in programs
               if p.kind != SEGMENT_FUSED)
    # the four Winograd singletons hold their product, the linears theirs
    held = {p.node_ids[0]: p.launches for p in programs
            if p.kind == SEGMENT_EXCLUSIVE}
    assert [n for n, c in held.items() if c.get("hadamard_matmul")] == \
        ["n3", "n4", "n7", "n8"]
    assert [n for n, c in held.items() if c.get("split_matmul")] == \
        ["n19", "n20"]


@pytest.mark.cuda
def test_the_captured_walk_matches_the_per_node_walk(card_exe):
    from repro_torch.runtime.segments import launch_counters
    counters = launch_counters()
    x0, x1 = _inputs(card_exe, 2)
    for x in (x0, x1):
        before = {k: c.launches for k, c in counters.items()}
        y_node, rep_node = card_exe.run(x)
        mid = {k: c.launches for k, c in counters.items()}
        y, rep = card_exe.run(x, fused=True)
        after = {k: c.launches for k, c in counters.items()}
        assert torch.equal(y, y_node)
        for k in ("hadamard_matmul", "split_matmul"):
            assert after[k] - mid[k] == mid[k] - before[k] > 0, k
        assert rep.sync_points == len(card_exe.segment_programs()) == 17
        assert [t.node_id for t in rep.timings] == \
            [t.node_id for t in rep_node.timings]


@pytest.mark.cuda
def test_a_returned_output_survives_the_next_request(card_exe):
    x0, x1 = _inputs(card_exe, 2)
    y0, _ = card_exe.run(x0, fused=True)
    kept = y0.clone()
    y1, _ = card_exe.run(x1, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(y0, kept)
    assert not torch.equal(y0, y1)
    last = card_exe.segment_programs()[-1]
    assert last.graph is not None
    assert y1.data_ptr() != last.static_output.data_ptr()


@pytest.mark.cuda
def test_each_captured_segment_span_holds_replay_sync_records(card_exe,
                                                              tmp_path):
    (x,) = _inputs(card_exe, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        card_exe.run(x, fused=True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("repro_torch."))
    (walk,) = [m for m in marks if m[2] == WALK]
    segments = [m for m in _inside(marks, walk) if SEGMENT.match(m[2])]
    programs = card_exe.segment_programs()
    assert [m[2] for m in segments] == [p.span for p in programs]
    for seg in segments:
        inner = [m[2] for m in _inside(marks, seg)]
        assert inner == [REPLAY, SYNC, RECORDS], seg[2]
        replay, sync, records = _inside(marks, seg)
        assert replay[1] <= sync[0] + EPS_US
        assert sync[1] <= records[0] + EPS_US
