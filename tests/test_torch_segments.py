"""The port's fused segment walk against the JAX package's, on the CPU.

The segment partition (`Graph.segments`, `CoexecPlan.segment_partition`)
is held equal to the reference's on the small compiled plans, on
`tiny_hybrid` with forced typed-axis splits, on both committed artifacts
and on random residual DAGs.  The fused walk (`run(fused=True)`) runs the
same instruction lists that the card captures as CUDA graphs, here
eagerly on two CPU groups: its output must be `torch.equal` to the
per-node walk's and within the stated tolerance of the reference's
`run_oracle` on the reference's own parameters.  The report's counts,
records and codec are held to the reference's.
"""
import json

import numpy as np
import pytest
import torch

import repro
from repro.core.partitioner import PartitionDecision
from repro.core.types import LinearOp as JaxLinearOp
from repro.graph.ir import Graph as JaxGraph
from repro.graph.ir import Node as JaxNode
from repro.runtime.executor import ExecutionReport as JaxExecutionReport
from repro.runtime.executor import PlanExecutor as JaxPlanExecutor
from repro.runtime.plan import CoexecPlan as JaxCoexecPlan
from repro.runtime.plan import (PlanProvenance, build_graph_schedule,
                                segments_json)

import repro_torch
from repro_torch.cli import main as cli_main
from repro_torch.core.types import LinearOp
from repro_torch.graph.ir import (SEGMENT_EXCLUSIVE, SEGMENT_FUSED,
                                  SEGMENT_POOL, Graph, Node, Segment)
from repro_torch.measure.record import (MODE_COEXEC, MODE_EXCLUSIVE,
                                        SOURCE_EXECUTOR, SOURCE_FUSED)
from repro_torch.runtime.executor import PlanExecutor
from repro_torch.runtime.plan import CoexecPlan

from test_torch_decode_exec import FORCED
from test_torch_support import (VGG16_ARTIFACT, ZAMBA_ARTIFACT,
                                compile_small, forced_split_doc)

# Winograd (n1) in the port against the reference's direct oracle: the
# transforms reassociate each output's fp32 sum
WINOGRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# linear chains: fp32 sums of at most 32 terms in another order, through
# up to 7 layers and 3 residual joins
LINEAR_TOL = dict(rtol=1e-5, atol=1e-5)
# decode nodes: fp32 sums in other orders and the kv-block log-sum-exp
# merge, through two residual blocks
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)


def _forced_doc(compiled, splits):
    """`forced_split_doc` without the compiled plan's embedded segment
    metadata, which no longer matches the forced splits: both packages
    re-derive the partition from the graph."""
    from repro.api import _artifact_checksum
    doc = forced_split_doc(compiled, splits)
    doc["plan"].pop("segments", None)
    doc.pop("checksum")
    doc["checksum"] = _artifact_checksum(doc)
    return doc


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _parts(partition):
    return [(s.kind, tuple(s.node_ids)) for s in partition]


def _port_plan(ref_plan) -> CoexecPlan:
    return CoexecPlan.from_json(json.loads(json.dumps(ref_plan.to_json())))


def _check_fused_run(exe, ref_plan, tol, *, channel_only=True):
    """Fused vs per-node vs the reference oracle on the reference's seed-3
    parameters; the report against the partition and the reference's
    graph; returns the fused report."""
    jexe = JaxPlanExecutor(ref_plan, seed=3)
    exe.load_params([None if p is None else np.asarray(p)
                     for p in jexe.params])
    x = np.asarray(jexe.input_template())
    y_node, rep_node = exe.run(x)
    y_fused, rep = exe.run(x, fused=True)
    assert torch.equal(y_fused, y_node)
    np.testing.assert_allclose(_np(y_fused), _np(jexe.run_oracle(x)), **tol)

    partition = ref_plan.segment_partition()
    assert rep.fused and not rep_node.fused
    assert rep.sync_points == len(partition) == len(rep.segment_wall_us)
    assert rep.sync_points <= rep_node.sync_points
    coexec = ref_plan.coexec_node_ids()
    graph = ref_plan.graph_ir()
    assert rep.elided == len(graph.elided(coexec))
    assert rep.reshard_points == len(graph.materialization_points(coexec))
    if channel_only:
        assert (rep.reshard_points, rep.elided) == \
            (rep_node.reshard_points, rep_node.elided)
    seg_of = ref_plan.segment_of()
    assert [t.node_id for t in rep.timings] == ref_plan.node_ids()
    assert all(t.source == SOURCE_FUSED for t in rep.timings)
    assert [t.segment for t in rep.timings] == \
        [seg_of[nid] for nid in ref_plan.node_ids()]
    for k, wall in enumerate(rep.segment_wall_us):
        members = sum(t.wall_us for t in rep.timings if t.segment == k)
        assert members == pytest.approx(wall, rel=1e-9)
    assert [t.mode for t in rep.timings] == \
        [t.mode for t in rep_node.timings]
    return rep


# ------------------------------------------------------ small compiled plans

@pytest.fixture(scope="module", params=["grid", "predicted"])
def compiled(request, tmp_path_factory):
    return compile_small(request.param, tmp_path_factory.mktemp("plans"))


#: channel splits forced onto the small network: n1 -> n2 chain (3x3 convs,
#: n1 Winograd), n4 and n5 (the stride-2 conv whose consumer adapts), and
#: the two linears (a chain across the global pool's edge)
SMALL_FORCED = {1: 16, 2: 16, 4: 40, 5: 64, 8: 24, 9: 3}


@pytest.mark.parametrize("forced", [False, True], ids=["as-compiled",
                                                       "forced"])
def test_small_plan_partition_and_fused_run(compiled, forced):
    doc = _forced_doc(compiled, SMALL_FORCED if forced else {})
    ref = repro.CompiledNetwork.from_json(doc, verify=False).plan
    port = repro_torch.CompiledNetwork.from_json(doc, verify=False)
    coexec = port.plan.coexec_node_ids()
    assert coexec == ref.coexec_node_ids()
    assert _parts(port.graph.segments(coexec)) == \
        _parts(ref.graph_ir().segments(coexec))
    assert _parts(port.plan.segment_partition()) == \
        _parts(ref.segment_partition())
    assert port.plan.segment_of() == ref.segment_of()
    if forced:
        fused = [s for s in port.plan.segment_partition()
                 if s.kind == SEGMENT_FUSED]
        assert any({"n1", "n2"} <= set(s.node_ids) for s in fused)
        assert ("n8", "n9") in [s.node_ids for s in fused]
    _check_fused_run(port.executor(device="cpu"), ref, WINOGRAD_TOL)


# ---------------------------------------------- tiny_hybrid, typed splits

@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    from repro.graph.frontends import from_model
    graph = from_model("tiny_hybrid", blocks=2, cache_len=512)
    return repro.compile(graph, repro.Target(device="moto2022", threads=3),
                         mode="grid", cache=tmp_path_factory.mktemp("plans"))


@pytest.mark.parametrize("variant", sorted(FORCED))
def test_typed_splits_are_singletons_and_the_fused_walk_matches(hybrid,
                                                               variant):
    doc = _forced_doc(hybrid, FORCED[variant])
    ref = repro.CompiledNetwork.from_json(doc, verify=False).plan
    port = repro_torch.CompiledNetwork.from_json(doc, verify=False)
    assert _parts(port.plan.segment_partition()) == \
        _parts(ref.segment_partition())
    assert _parts(port.graph.segments(port.plan.coexec_node_ids())) == \
        _parts(ref.graph_ir().segments(ref.coexec_node_ids()))
    exe = port.executor(device="cpu")
    rep = _check_fused_run(exe, ref, DECODE_TOL, channel_only=False)
    # every typed split co-executes, as an exclusive-segment singleton
    seg = {nid: s for s in port.plan.segment_partition()
           for nid in s.node_ids}
    by_id = {t.node_id: t for t in rep.timings}
    for nid, share in FORCED[variant].items():
        if isinstance(share, tuple):
            assert seg[nid].kind == SEGMENT_EXCLUSIVE
            assert seg[nid].node_ids == (nid,)
            assert by_id[nid].mode == "coexec"
    # ... and stays eager, while the exclusive linears are captured
    programs = assert_capture_rule(exe)
    eager = {p.node_ids[0] for p in programs if not p.captured}
    assert {nid for nid, share in FORCED[variant].items()
            if isinstance(share, tuple)} <= eager
    assert any(p.kind == SEGMENT_EXCLUSIVE and p.captured
               for p in programs)


@pytest.mark.parametrize("compiled,variant", [
    ("grid", "small"), ("predicted", "small"), ("grid", "head"),
    ("grid", "ssm-state")], indirect=["compiled"])
def test_both_walks_record_alike(compiled, hybrid, variant):
    """One request's records from the per-node and the fused walk agree on
    every field but `wall_us` and `source`, except where the walks differ
    in what a node does:

      * `chained_input`: the per-node walk also chains the edges into and
        out of a typed-axis split, which the fused walk runs as a
        singleton segment, gathering its input first and its output
        inside its own lowering; so a record chains in the fused walk
        only where it does in the per-node walk, and only inside one
        segment;
      * `gathered_output`: where a split node's consumer does not chain
        its output, the per-node walk leaves it group-local and the
        consumer's step gathers it, while the fused walk gathers it
        inside the producer's segment."""
    src, splits = ((compiled, SMALL_FORCED) if variant == "small"
                   else (hybrid, FORCED[variant]))
    port = repro_torch.CompiledNetwork.from_json(_forced_doc(src, splits),
                                                 verify=False)
    exe = port.executor(device="cpu")
    _, node = exe.run()
    _, fused = exe.run(fused=True)
    graph, seg_of = port.graph, port.plan.segment_of()
    assert len(node.timings) == len(fused.timings) == len(exe.specs)
    differs = set()
    for a, b in zip(node.timings, fused.timings):
        da, db = a.to_json(), b.to_json()
        for key in ("wall_us", "source"):
            da.pop(key), db.pop(key)
        differs |= {k for k in da if da[k] != db[k]}
        if b.chained_input:
            assert a.chained_input
        if a.chained_input and not b.chained_input:
            src_id = graph.node(a.node_id).inputs[0]
            assert seg_of[src_id] != seg_of[a.node_id], a.node_id
        if a.gathered_output != b.gathered_output:
            assert a.mode == MODE_COEXEC and b.gathered_output, a.node_id
    assert differs <= {"chained_input", "gathered_output"}
    assert (node.timings[0].source, fused.timings[0].source) == \
        (SOURCE_EXECUTOR, SOURCE_FUSED)


# ------------------------------------------------------ committed artifacts

@pytest.mark.parametrize("path", [VGG16_ARTIFACT, ZAMBA_ARTIFACT],
                         ids=["vgg16", "zamba2-7b"])
def test_committed_artifacts_partition_alike(path):
    ref = repro.CompiledNetwork.load(path).plan
    port = repro_torch.CompiledNetwork.load(path).plan
    assert _parts(port.segment_partition()) == _parts(ref.segment_partition())
    # the embedded metadata is what the graph re-derives
    assert _parts(port.graph_ir().segments(port.coexec_node_ids())) == \
        _parts(port.segment_partition())
    kinds = [s.kind for s in port.segment_partition()]
    want = {"vgg16": (17, 4), "zamba2-7b": (30, 18)}[
        "vgg16" if path == VGG16_ARTIFACT else "zamba2-7b"]
    assert (len(kinds), kinds.count(SEGMENT_FUSED)) == want
    assert [s.segment for s in port.exec_specs()] == \
        [s.segment for s in ref.exec_specs()]


def test_stale_segment_metadata_is_re_derived():
    doc = json.loads(VGG16_ARTIFACT.read_text())["plan"]
    want = _parts(CoexecPlan.from_json(doc).segment_partition())
    for segments in (None, doc["segments"][1:]):
        d = dict(doc)
        if segments is None:
            d.pop("segments")
        else:
            d["segments"] = segments
        assert _parts(CoexecPlan.from_json(
            d, verify=False).segment_partition()) == want


def test_segment_validates():
    s = Segment(kind=SEGMENT_POOL, node_ids=["a"])
    assert s.node_ids == ("a",) and len(s) == 1
    with pytest.raises(ValueError):
        Segment(kind="bogus", node_ids=("a",))
    with pytest.raises(ValueError):
        Segment(kind=SEGMENT_FUSED, node_ids=())


# ---------------------------------------------------- random residual DAGs

def _residual_nodes(rng, n_blocks: int, branch: bool):
    """(id, C_in, C_out, inputs) of embed -> n_blocks x (u = linear,
    v = linear, r = add(prev, v)); C_out None for an add.  With `branch`,
    odd blocks take two parallel linears instead, u and w, with w feeding
    an exclusive linear e and r = add(u, e): the run [u, w] then breaks
    convexity (u's consumer lies past w's cut)."""
    c = int(rng.choice([16, 24, 32]))
    mid = int(rng.choice([c, 8]))
    nodes = [("embed", c, c, ())]
    prev = "embed"
    for b in range(n_blocks):
        if branch and b % 2:
            nodes += [(f"b{b}.u", c, c, (prev,)),
                      (f"b{b}.w", c, mid, (prev,)),
                      (f"b{b}.e", mid, c, (f"b{b}.w",)),
                      (f"b{b}.r", None, None, (f"b{b}.u", f"b{b}.e"))]
        else:
            nodes += [(f"b{b}.u", c, mid, (prev,)),
                      (f"b{b}.v", mid, c, (f"b{b}.u",)),
                      (f"b{b}.r", None, None, (prev, f"b{b}.v"))]
        prev = f"b{b}.r"
    return nodes


def _residual_plans(seed: int, n_blocks: int, exclusive: int,
                    embed_segments: bool, branch: bool):
    """The same random residual DAG as a reference plan (every linear
    channel-split ~3/4 : 1/4, `exclusive` of them and every `.e` on one
    side) and as the port's graph."""
    rng = np.random.default_rng(seed)
    nodes = _residual_nodes(rng, n_blocks, branch)
    L = int(rng.integers(1, 4))
    jnodes, pnodes = [], []
    for nid, c_in, c_out, inputs in nodes:
        if c_out is None:
            jnodes.append(JaxNode(id=nid, kind="add", inputs=inputs))
            pnodes.append(Node(id=nid, kind="add", inputs=inputs))
        else:
            jnodes.append(JaxNode(id=nid, kind="linear",
                                  op=JaxLinearOp(L, c_in, c_out),
                                  inputs=inputs))
            pnodes.append(Node(id=nid, kind="linear",
                               op=LinearOp(L, c_in, c_out), inputs=inputs))
    g = JaxGraph(jnodes)
    linears = [n for n in g if n.kind == "linear"]
    solo = {n.id for n in rng.choice(linears, size=exclusive, replace=False)}
    solo |= {n.id for n in linears if n.id.endswith(".e")}
    decisions = {}
    for n in linears:
        c = n.op.C_out
        c_cpu = 0 if n.id in solo else max(1, c // 4)
        decisions[n.id] = PartitionDecision(
            op=n.op, c_cpu=c_cpu, c_gpu=c - c_cpu, pred_cpu_us=1.0,
            pred_gpu_us=float(rng.integers(1, 5)), pred_total_us=float(
                rng.integers(1, 5)))
    prov = PlanProvenance(
        device="moto2022", threads=3, mechanism="svm_poll", step=8, seed=1,
        network_fingerprint=g.fingerprint(), predictor_checksum="")
    ref = JaxCoexecPlan(
        provenance=prov, schedule=build_graph_schedule(g, decisions, {}),
        graph_json=g.to_json(),
        segments=segments_json(g, decisions) if embed_segments else None)
    return ref, Graph(pnodes)


@pytest.mark.parametrize("seed,n_blocks,exclusive,embed,branch", [
    (0, 1, 0, True, False), (1, 2, 0, True, False), (2, 3, 1, True, False),
    (3, 2, 2, False, False), (4, 3, 0, False, False), (5, 1, 1, True, False),
    (6, 3, 2, True, False), (7, 2, 1, False, False), (8, 2, 0, True, True),
    (9, 3, 1, False, True), (10, 4, 0, True, True), (11, 4, 2, False, True)])
def test_random_residual_dag_partitions_and_runs_alike(seed, n_blocks,
                                                       exclusive, embed,
                                                       branch):
    ref, pgraph = _residual_plans(seed, n_blocks, exclusive, embed, branch)
    port = _port_plan(ref)
    coexec = ref.coexec_node_ids()
    assert port.coexec_node_ids() == coexec
    assert _parts(pgraph.segments(coexec)) == \
        _parts(ref.graph_ir().segments(coexec))
    assert _parts(port.segment_partition()) == \
        _parts(ref.segment_partition())
    assert pgraph.materialization_points(coexec) == \
        ref.graph_ir().materialization_points(coexec)
    if branch:                        # the convexity pass split a run
        assert ("b1.u",) in [s.node_ids for s in port.segment_partition()]
    exe = PlanExecutor(port, device="cpu")
    _check_fused_run(exe, ref, LINEAR_TOL)


# ------------------------------------------------------- errors and reuse

@pytest.fixture()
def forced_exe(compiled):
    doc = _forced_doc(compiled, SMALL_FORCED)
    return repro_torch.CompiledNetwork.from_json(doc).executor(device="cpu")


def test_fused_needs_chaining(forced_exe):
    with pytest.raises(ValueError, match="chain"):
        forced_exe.run(fused=True, chain=False)


def test_load_params_after_a_fused_run_changes_the_fused_output(forced_exe):
    y0, _ = forced_exe.run(fused=True)
    programs = forced_exe.segment_programs()
    rng = np.random.default_rng(9)
    forced_exe.load_params([
        None if p is None else rng.standard_normal(tuple(p.shape))
        for p in forced_exe.params])
    assert forced_exe.segment_programs() is not programs   # rebuilt
    y1, _ = forced_exe.run(fused=True)
    assert not torch.equal(y1, y0)
    y_node, _ = forced_exe.run()
    assert torch.equal(y1, y_node)


def test_fused_warmup_runs_once_and_publishes_only_the_timed_run(forced_exe):
    y1, r1 = forced_exe.run(warmup=True, fused=True)
    y2, r2 = forced_exe.run(warmup=True, fused=True)
    assert forced_exe.last_report is r2 and r1 is not r2
    assert torch.equal(y1, y2)


def assert_capture_rule(exe):
    """Which programs are `captured`, which the card replays as graphs:
    fused segments, pools and exclusive conv and linear singletons;
    typed-axis splits and exclusive ssm and attention singletons run
    eagerly.  Every program carries an `fn`.  On the CPU no program holds
    a graph.  Returns the programs."""
    units = {s.node_id: s.unit for s in exe.specs}
    programs = exe.segment_programs()
    for p in programs:
        assert p.graph is None and not p.launches, p.span
        nid = p.node_ids[0]
        captured = (p.kind in (SEGMENT_FUSED, SEGMENT_POOL)
                    or (p.kind == SEGMENT_EXCLUSIVE
                        and p.modes[nid] == MODE_EXCLUSIVE
                        and units[nid] in ("conv", "linear")))
        assert p.captured == captured, p.span
        assert callable(p.fn), p.span
    return programs


def test_cpu_segments_run_eagerly(forced_exe):
    programs = assert_capture_rule(forced_exe)
    assert {p.kind for p in programs if p.captured} == \
        {SEGMENT_FUSED, SEGMENT_POOL, SEGMENT_EXCLUSIVE}


# ----------------------------------------------- report codec, entry points

def test_report_codec_is_the_reference_one(forced_exe):
    _, rep = forced_exe.run(fused=True)
    doc = rep.to_json()
    ref = JaxExecutionReport.from_json(doc)
    assert ref.to_json() == doc
    assert set(doc) == set(ref.to_json())
    back = type(rep).from_json(doc)
    assert back.to_json() == doc
    assert rep.fidelity_error() == pytest.approx(ref.fidelity_error(),
                                                 rel=1e-12)
    assert rep.mean_log_ratio() == pytest.approx(ref.mean_log_ratio(),
                                                 rel=1e-12)
    summary = rep.fidelity_summary()
    assert f"{len(rep.segment_wall_us)} segments ({rep.sync_points} " \
        f"syncs)" in summary


def test_api_passes_fused_through(compiled, tmp_path):
    path = tmp_path / "small.coexec.json"
    path.write_text(json.dumps(_forced_doc(compiled, SMALL_FORCED)))
    port = repro_torch.CompiledNetwork.load(path)
    y_node = port.run(device="cpu")
    y = port.run(device="cpu", fused=True)
    assert torch.equal(y, y_node) and port.last_report.fused
    report = port.profile(device="cpu", fused=True)
    assert report.fused and port.last_report is report


def test_cli_execute_fused(compiled, tmp_path, capsys):
    path = tmp_path / "small.coexec.json"
    path.write_text(json.dumps(_forced_doc(compiled, SMALL_FORCED)))
    assert cli_main(["execute", "--artifact", str(path), "--device", "cpu",
                     "--fused", "--per-op"]) == 0
    out = capsys.readouterr().out
    n = len(repro_torch.CompiledNetwork.load(path).plan.segment_partition())
    assert f"fused: {n} segments, {n} syncs (vs " in out
    assert "outputs bit-identical" in out and " seg=" in out
