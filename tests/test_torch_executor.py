"""The port's plan executor against the JAX package's, on the CPU.

A small network is compiled by the JAX package (grid and predicted mode),
saved as an artifact, loaded by the port and run on two CPU groups.  Its
output is held against the reference's unsplit oracle and its Pallas run
(`interpret=True`), with the reference's own parameters; the reshard and
elision counts against the reference's `Graph.elided`.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels.registry import op_to_json as jax_op_to_json
from repro.runtime.executor import PlanExecutor as JaxPlanExecutor
from repro.runtime.executor import _fit_axis as jax_fit_axis

import repro_torch
from repro_torch.core.coexec import coexec_groups
from repro_torch.kernels.registry import op_to_json
from repro_torch.kernels.split_matmul import split_matmul
from repro_torch.kernels.winograd_conv import hadamard_matmul
from repro_torch.runtime.executor import PlanExecutor, _fit_axis
from repro_torch.runtime.plan import CoexecPlan

from test_torch_support import compile_small, forced_split_doc

# Winograd (n1 runs it in both packages' kernel paths) against the direct
# oracle: the transforms reassociate each output's fp32 sum
WINOGRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the same algorithm in both packages: fp32 summation order only
SAME_ALGO_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=["grid", "predicted"])
def compiled(request, tmp_path_factory):
    return compile_small(request.param, tmp_path_factory.mktemp("plans"))


@pytest.fixture(scope="module")
def port_compiled(compiled, tmp_path_factory):
    path = tmp_path_factory.mktemp("artifact") / "small.coexec.json"
    compiled.save(path)
    return repro_torch.CompiledNetwork.load(path)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_plan_decodes_to_the_reference_specs(compiled, port_compiled):
    ref = compiled.plan.exec_specs()
    got = port_compiled.plan.exec_specs()
    assert [(s.unit, None if s.op is None else jax_op_to_json(s.op),
             s.pool_bytes, s.c_fast, s.c_slow, s.pred_total_us, s.axis,
             s.node_id, s.segment) for s in ref] == \
        [(s.unit, None if s.op is None else op_to_json(s.op), s.pool_bytes,
          s.c_fast, s.c_slow, s.pred_total_us, s.axis, s.node_id, s.segment)
         for s in got]
    assert port_compiled.key == compiled.key
    assert port_compiled.graph.fingerprint() == \
        compiled.plan.graph_ir().fingerprint()
    assert port_compiled.plan.coexec_node_ids() == \
        compiled.plan.coexec_node_ids()
    assert port_compiled.plan.to_json() == compiled.plan.to_json()


def test_run_matches_reference_oracle_and_pallas_run(compiled,
                                                     port_compiled):
    exe = port_compiled.executor(device="cpu")
    jexe = JaxPlanExecutor(compiled.plan, seed=0)
    # one seed, one set of numpy weights and inputs in both packages
    for p, q in zip(exe.params, jexe.params):
        assert (p is None) == (q is None)
        if p is not None:
            np.testing.assert_array_equal(_np(p), _np(q))
    np.testing.assert_array_equal(_np(exe.input_template()),
                                  _np(jexe.input_template()))

    before = (split_matmul.launches, hadamard_matmul.launches)
    y, report = exe.run()
    assert (split_matmul.launches, hadamard_matmul.launches) == before
    want = _np(jexe.run_oracle())
    assert y.shape == want.shape == (1, 10)
    np.testing.assert_allclose(_np(y), want, **WINOGRAD_TOL)
    np.testing.assert_allclose(_np(exe.run_oracle()), want, **SAME_ALGO_TOL)
    y_pallas, _ = JaxPlanExecutor(compiled.plan, seed=0, use_pallas=True,
                                  interpret=True).run()
    np.testing.assert_allclose(_np(y), _np(y_pallas), **WINOGRAD_TOL)

    coexec = compiled.plan.coexec_node_ids()
    elided = compiled.plan.graph_ir().elided(coexec)
    assert report.split_capable
    assert report.count("coexec") == len(coexec) > 0
    assert report.elided == len(elided)
    assert report.reshard_points == len(coexec - elided)
    assert report.sync_points == len(report.timings) + 1
    assert [t.node_id for t in report.timings] == compiled.plan.node_ids()


def test_load_params_carries_the_reference_parameters(compiled,
                                                      port_compiled):
    jexe = JaxPlanExecutor(compiled.plan, seed=7)
    exe = PlanExecutor(port_compiled.plan, device="cpu", seed=0)
    y0, _ = exe.run()
    exe.load_params([None if p is None else np.asarray(p)
                     for p in jexe.params])
    x = np.asarray(jexe.input_template())
    y, _ = exe.run(x)
    assert not torch.equal(y, y0)
    np.testing.assert_allclose(_np(y), _np(jexe.run_oracle(jnp.asarray(x))),
                               **WINOGRAD_TOL)
    with pytest.raises(ValueError):
        exe.load_params([None] * (len(exe.specs) - 1))
    with pytest.raises(ValueError):
        exe.load_params([np.zeros((2, 2))] * len(exe.specs))


def test_forced_chained_splits_elide_the_gather(compiled):
    """Splits forced onto n1 and n2 (16/112 each): n1's output feeds only
    n2 with exactly n2's declared input shape, so the CPU walk chains
    through x_plan and never gathers it."""
    doc = forced_split_doc(compiled, {1: 16, 2: 16})
    port = repro_torch.CompiledNetwork.from_json(doc, verify=False)
    ref = repro.CompiledNetwork.from_json(doc, verify=False)
    coexec = ref.plan.coexec_node_ids()
    elided = ref.plan.graph_ir().elided(coexec)
    assert {"n1", "n2"} <= coexec and "n1" in elided

    exe = port.executor(device="cpu")
    y, report = exe.run()
    assert report.elided == len(elided)
    assert report.reshard_points == len(coexec - elided)
    by_id = {t.node_id: t for t in report.timings}
    assert by_id["n2"].chained_input and not by_id["n1"].gathered_output
    want = _np(JaxPlanExecutor(ref.plan, seed=0).run_oracle())
    np.testing.assert_allclose(_np(y), want, **WINOGRAD_TOL)

    # gathering after every split op: the same values reach every node
    y_unchained, rep = exe.run(chain=False)
    assert rep.elided == 0 and rep.reshard_points == len(coexec)
    assert torch.equal(y_unchained, y)

    # one group: every node exclusive, the same output
    doc["target"]["mesh"] = "single"
    from repro.api import _artifact_checksum
    doc.pop("checksum")
    doc["checksum"] = _artifact_checksum(doc)
    single = repro_torch.CompiledNetwork.from_json(doc, verify=False)
    y_single = single.run(device="cpu")
    rep = single.last_report
    assert not rep.split_capable and rep.count("coexec") == 0
    assert rep.reshard_points == 0
    np.testing.assert_allclose(_np(y_single), _np(y), **SAME_ALGO_TOL)


def test_warmup_runs_once_and_publishes_only_the_timed_run(port_compiled):
    exe = PlanExecutor(port_compiled.plan, device="cpu")
    y1, r1 = exe.run(warmup=True)
    y2, r2 = exe.run(warmup=True)
    assert exe.last_report is r2 and r1 is not r2
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("cur,size,adapt", [(8, 16, True), (16, 16, False),
                                            (16, 10, True), (24, 20, False),
                                            (3, 7, True)])
def test_fit_axis_matches_the_reference(cur, size, adapt):
    x = np.arange(2 * cur * 3, dtype=np.float32).reshape(2, cur, 3)
    got = _fit_axis(torch.tensor(x), 1, size, adapt=adapt)
    want = jax_fit_axis(jnp.asarray(x), 1, size, adapt=adapt)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("cur,size", [(8, 16), (40, 20), (20, 30)])
def test_fit_axis_is_strict_unless_adapting(cur, size):
    with pytest.raises(ValueError, match="does not adapt"):
        _fit_axis(torch.zeros(2, cur), 1, size)


def test_executor_rejects_a_plan_for_another_graph(compiled):
    doc = json.loads(json.dumps(compiled.plan.to_json()))
    doc["provenance"]["network_fingerprint"] = "0" * 24
    with pytest.raises(ValueError, match="fingerprint"):
        PlanExecutor(CoexecPlan.from_json(doc), device="cpu")
    doc = json.loads(json.dumps(compiled.plan.to_json()))
    doc["schedule"][0]["unit"] = "linear"        # a conv decision
    with pytest.raises(ValueError):
        PlanExecutor(CoexecPlan.from_json(doc), device="cpu")


def test_measurement_records_are_the_reference_schema(port_compiled):
    from repro.measure.record import MeasurementRecord as JaxRecord
    from repro_torch.measure.record import MeasurementRecord
    _, report = port_compiled.executor(device="cpu").run()
    for t in report.timings:
        d = t.to_json()
        assert JaxRecord.from_json(d).to_json() == d
        assert MeasurementRecord.from_json(d) == t


def test_one_group_executor_on_explicit_groups(port_compiled):
    exe = PlanExecutor(port_compiled.plan, groups=coexec_groups("cpu", n=1))
    y, report = exe.run()
    assert report.count("coexec") == 0
    np.testing.assert_allclose(_np(y), _np(exe.run_oracle()),
                               **WINOGRAD_TOL)
    assert dataclasses.asdict(report.timings[0])["backend"] == "cpu"


# ------------------------------------------------------------ bf16, splits
@pytest.mark.parametrize("forced", [False, True],
                         ids=["as-planned", "halves-forced"])
@pytest.mark.parametrize("network,n_units", [("resnet18", 5), ("vgg16", 4)])
def test_bf16_network_prefix_matches_the_reference(tmp_path, network,
                                                   n_units, forced):
    """The reference's bf16 end-to-end cases (`tests/test_executor.py`): a
    network's first units, compiled by the JAX package, run in bfloat16 on
    two CPU groups, as planned and with every conv/linear split in halves
    (so both sides of a split run in bf16); held against the reference's
    bf16 run and the port's own bf16 oracle at the reference's 5e-2."""
    from repro.api import _artifact_checksum
    from repro.core.networks import NETWORKS
    units = NETWORKS[network]()[:n_units]
    compiled = repro.compile(units, repro.Target(device="moto2022",
                                                 threads=3),
                             mode="grid", cache=tmp_path / "plans")
    doc = compiled.to_json()
    if forced:
        doc = forced_split_doc(compiled, {
            i: e["decision"]["op"]["C_out"] // 16 * 8
            for i, e in enumerate(doc["plan"]["schedule"])
            if "decision" in e})
        doc["plan"].pop("segments")          # re-derived for the splits
        doc["checksum"] = _artifact_checksum(doc)
    ref = repro.CompiledNetwork.from_json(doc)
    port = repro_torch.CompiledNetwork.from_json(doc)
    exe = port.executor(device="cpu", dtype="bfloat16")
    assert all(p is None or p.dtype == torch.bfloat16 for p in exe.params)
    y, report = exe.run()
    assert y.dtype == torch.bfloat16 and len(report.timings) == n_units
    assert report.count("coexec") == len(port.plan.coexec_node_ids())
    assert port.plan.coexec_node_ids() or not forced
    want, _ = JaxPlanExecutor(ref.plan, dtype=jnp.bfloat16).run()
    np.testing.assert_allclose(_np(y.float()), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(y.float()), _np(exe.run_oracle().float()),
                               rtol=5e-2, atol=5e-2)
    y_fused, _ = exe.run(fused=True)
    assert torch.equal(y_fused, y)


def test_load_params_casts_to_the_executor_dtype(compiled, port_compiled):
    jexe = JaxPlanExecutor(compiled.plan, seed=7)
    arrays = [None if p is None else np.asarray(p) for p in jexe.params]
    exe = PlanExecutor(port_compiled.plan, device="cpu", dtype="bfloat16")
    assert exe.dtype == torch.bfloat16
    assert exe.input_template().dtype == torch.bfloat16
    exe.load_params(arrays)
    for p, a in zip(exe.params, arrays):
        if a is not None:
            assert torch.equal(p, torch.tensor(a).to(torch.bfloat16))
    x = np.asarray(jexe.input_template())
    y, _ = exe.run(x)
    jy, _ = JaxPlanExecutor(compiled.plan, seed=7, dtype=jnp.bfloat16).run(
        jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(_np(y.float()), np.asarray(jy, np.float32),
                               rtol=5e-2, atol=5e-2)
    with pytest.raises(ValueError, match="dtype"):
        PlanExecutor(port_compiled.plan, device="cpu", dtype=torch.float16)


def test_throughput_split_matches_the_reference():
    from repro.core.coexec import throughput_split as jax_throughput_split
    from repro_torch.core.coexec import throughput_split
    for c_out in (1, 7, 64, 1000, 4096):
        for share in (0.0, 0.01, 0.3, 0.5, 0.77, 0.999, 1.0):
            for align in (1, 8, 128):
                got = throughput_split(c_out, share, align=align)
                want = jax_throughput_split(c_out, share, align=align)
                assert (got.c_out, got.c_fast, got.c_slow, got.align,
                        got.c_pad) == (want.c_out, want.c_fast, want.c_slow,
                                       want.align, want.c_pad)
