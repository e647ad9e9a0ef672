"""The port's planning half against the reference's, module by module:
the simulated phones, the GBDT predictors and their checksums, the
partitioner, the planner and the plan cache.  Both packages run the same
host numpy on the same inputs, so every comparison here is exact: `==` on
floats, arrays, hashes and JSON."""
import collections
import dataclasses
import hashlib
import json
import pickle

import numpy as np
import pytest

import repro.core.types as jt
from repro.analysis import rejections as jax_rejections
from repro.core.networks import NETWORKS as JAX_NETWORKS
from repro.core.partitioner import (
    axis_partition_batch as jax_axis_partition_batch,
    axis_realized_latency_us_batch as jax_axis_realized,
    grid_axis_partition_batch as jax_grid_axis_partition_batch,
    grid_search_partition as jax_grid_search_partition,
    grid_search_partition_batch as jax_grid_search_partition_batch,
    optimal_partition_batch as jax_optimal_partition_batch,
    realized_latency_us as jax_realized_latency_us,
    realized_latency_us_batch as jax_realized_latency_us_batch,
    speedup_vs_gpu as jax_speedup_vs_gpu,
    speedup_vs_gpu_batch as jax_speedup_vs_gpu_batch)
from repro.core.planner import grid_plan_graph as jax_grid_plan_graph
from repro.core.planner import plan_graph as jax_plan_graph
from repro.core.planner import plan_network as jax_plan_network
from repro.core.predictor import dataset as jax_dataset
from repro.core.predictor.gbdt import GBDTParams as JaxGBDTParams
from repro.core.predictor.gbdt import GBDTRegressor as JaxGBDTRegressor
from repro.core.predictor.train import mape as jax_mape
from repro.core.predictor.train import measure_ops as jax_measure_ops
from repro.core.simulator import measure as jax_measure
from repro.core.sync import SyncMechanism as JaxSync
from repro.graph.frontends import fan_out_demo as jax_fan_out_demo
from repro.graph.frontends import from_model as jax_from_model
from repro.graph.frontends import model_names as jax_model_names
from repro.graph.frontends import resolve_config as jax_resolve_config
from repro.graph.ir import from_units as jax_from_units
from repro.runtime import cache as jax_cache_module
from repro.runtime.cache import PlanCache as JaxPlanCache
from repro.runtime.plan import _hash_gbdt as jax_hash_gbdt
from repro.runtime.plan import decision_to_json as jax_decision_to_json
from repro.runtime.plan import PlanProvenance as JaxProvenance
from repro.runtime.plan import predictor_checksum as jax_predictor_checksum
from repro.runtime.plan import train_mux_predictors as jax_train_mux

from repro_torch.analysis import rejections
from repro_torch.core.networks import NETWORKS
from repro_torch.core.partitioner import (
    axis_partition_batch, axis_realized_latency_us_batch,
    grid_axis_partition_batch, grid_search_partition,
    grid_search_partition_batch, optimal_partition_batch,
    realized_latency_us, realized_latency_us_batch, speedup_vs_gpu,
    speedup_vs_gpu_batch)
from repro_torch.core.planner import grid_plan_graph, plan_graph, plan_network
from repro_torch.core.predictor import dataset
from repro_torch.core.predictor.gbdt import GBDTParams, GBDTRegressor
from repro_torch.core.predictor.train import (LatencyPredictor, mape,
                                              measure_ops)
from repro_torch.core.simulator import measure
from repro_torch.core.simulator.devices import DEVICES
from repro_torch.core.sync import SyncMechanism
from repro_torch.graph.frontends import (fan_out_demo, from_model,
                                         model_names, resolve_config)
from repro_torch.graph.ir import from_units
from repro_torch.runtime import cache as cache_module
from repro_torch.runtime.cache import PlanCache, plan_graph_cached
from repro_torch.runtime.plan import (_hash_gbdt, decision_to_json,
                                      predictor_checksum,
                                      train_mux_predictors)

from test_torch_support import to_port

#: the zamba2-7b step of the committed artifact
ZAMBA = dict(blocks=9, cache_len=4096)


def _network_ops(make_graph, networks):
    ops = []
    for name in sorted(networks):
        ops += [n.op for n in make_graph(networks[name]())
                if n.op is not None]
    return ops


def jax_ops():
    """Every op of the five networks, with every channel slice the
    partitioner prices at step 8 of the first few, and a seeded draw of
    each of dataset.py's generators."""
    ops = _network_ops(jax_from_units, JAX_NETWORKS)
    ops += [n.op for n in jax_from_model("zamba2-7b", **ZAMBA)
            if n.op is not None]
    ops += [n.op for n in jax_from_model("tiny_hybrid") if n.op is not None]
    for op in list(ops[:6]):
        if isinstance(op, (jt.LinearOp, jt.ConvOp)):
            ops += [op.with_cout(c) for c in range(8, op.C_out, 8)]
    ops += jax_dataset.sample_linear_ops(40, seed=3)
    ops += jax_dataset.sample_conv_ops(40, seed=3)
    ops += jax_dataset.sample_attn_ops(40, seed=3)
    ops += jax_dataset.sample_ssm_ops(40, seed=3)
    return ops


JAX_OPS = jax_ops()


# ----------------------------------------------------------------- types
@pytest.mark.parametrize("name", sorted(NETWORKS) + ["zamba2-7b"])
def test_every_op_reprs_alike_in_both_packages(name):
    """`_stable_seed` hashes `repr(op)`: it must be the same string."""
    if name in NETWORKS:
        ref = [u[1] for u in JAX_NETWORKS[name]() if u[0] != "pool"]
        port = [u[1] for u in NETWORKS[name]() if u[0] != "pool"]
    else:
        ref = [n.op for n in jax_from_model(name, **ZAMBA) if n.op]
        port = [n.op for n in from_model(name, **ZAMBA) if n.op]
    assert [repr(op) for op in port] == [repr(op) for op in ref]
    assert [repr(to_port(op)) for op in ref] == [repr(op) for op in ref]
    assert [(op.flops, op.input_bytes, op.weight_bytes, op.output_bytes)
            for op in port] == \
        [(op.flops, op.input_bytes, op.weight_bytes, op.output_bytes)
         for op in ref]


def test_dataset_generators_draw_the_reference_ops():
    for gen in ("sample_linear_ops", "sample_conv_ops", "sample_attn_ops",
                "sample_ssm_ops"):
        assert [repr(op) for op in getattr(dataset, gen)(50, seed=7)] == \
            [repr(op) for op in getattr(jax_dataset, gen)(50, seed=7)]
    assert dataset.eval_linear_ops()[::97] == \
        [to_port(op) for op in jax_dataset.eval_linear_ops()[::97]]
    assert dataset.eval_conv_ops()[::97] == \
        [to_port(op) for op in jax_dataset.eval_conv_ops()[::97]]


@pytest.mark.parametrize("name", model_names())
def test_model_graphs_are_the_reference_graphs(name):
    """Every name `from_model` resolves gives the reference's config and
    graph (the same content-addressed fingerprint and node list)."""
    assert dataclasses.asdict(resolve_config(name)) == \
        dataclasses.asdict(jax_resolve_config(name))
    kw = dict(blocks=3, cache_len=512, batch=2)
    got, want = from_model(name, **kw), jax_from_model(name, **kw)
    assert got.fingerprint() == want.fingerprint()
    assert got.to_json() == want.to_json()


def test_fan_out_demo_is_the_reference_demo():
    (got, gid), (want, wid) = fan_out_demo(), jax_fan_out_demo()
    assert (got.to_json(), gid) == (want.to_json(), wid)
    assert model_names() == jax_model_names()


# ------------------------------------------------------------- simulator
@pytest.mark.parametrize("backend", ["gpu", "cpu1", "cpu3"])
@pytest.mark.parametrize("device", sorted(DEVICES))
def test_simulator_observes_what_the_reference_observes(device, backend):
    port_ops = [to_port(op) for op in JAX_OPS]
    want = [jax_measure.true_latency_us(op, device, backend)
            for op in JAX_OPS]
    assert [measure.true_latency_us(op, device, backend)
            for op in port_ops] == want
    for seed in (0, 1):
        got = measure.measure_latency_us_batch(port_ops, device, backend,
                                               seed=seed)
        ref = jax_measure.measure_latency_us_batch(JAX_OPS, device, backend,
                                                   seed=seed)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert measure._stable_seed(device, backend, port_ops[0], 1) == \
        jax_measure._stable_seed(device, backend, JAX_OPS[0], 1)


# ------------------------------------------------------------------ GBDT
@pytest.mark.parametrize("params", [
    dict(n_estimators=20),
    dict(n_estimators=15, subsample=1.0, max_depth=4),
    dict(n_estimators=10, max_bins=16, min_child_samples=2, reg_lambda=0.1),
])
def test_gbdt_fits_and_predicts_the_reference_trees(params):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((300, 6)) * [1, 10, 100, 1, 0.1, 3]
    X[:, 3] = rng.integers(0, 4, 300)           # a few distinct values
    y = np.sin(X[:, 0]) + 0.01 * X[:, 1] + rng.standard_normal(300) * 0.1
    port = GBDTRegressor(GBDTParams(**params), seed=3).fit(X, y)
    ref = JaxGBDTRegressor(JaxGBDTParams(**params), seed=3).fit(X, y)
    assert port.base_ == ref.base_
    assert len(port.trees) == len(ref.trees)
    for a, b in zip(port.bin_edges_, ref.bin_edges_):
        assert np.array_equal(a, b)
    for ta, tb in zip(port.trees, ref.trees):
        for field in ("feature", "threshold_bin", "left", "right", "value"):
            assert np.array_equal(getattr(ta, field), getattr(tb, field))
    X_new = rng.standard_normal((50, 6)) * 50
    assert np.array_equal(port.predict(X_new), ref.predict(X_new))
    h_port, h_ref = hashlib.blake2b(), hashlib.blake2b()
    _hash_gbdt(h_port, port)
    jax_hash_gbdt(h_ref, ref)
    assert h_port.hexdigest() == h_ref.hexdigest()


#: (threads, kinds) of the two predictor bundles the artifacts plan with
BUNDLES = {"cpu3 linear+conv": (3, ("linear", "conv")),
           "cpu1 all kinds": (1, ("linear", "conv", "attention", "ssm"))}


@pytest.fixture(scope="module")
def bundles():
    """Both packages' small predictor bundles (samples=120,
    estimators=25), trained on moto2022."""
    out = {}
    for name, (threads, kinds) in BUNDLES.items():
        out[name] = (train_mux_predictors("moto2022", threads, samples=120,
                                          estimators=25, kinds=kinds),
                     jax_train_mux("moto2022", threads, samples=120,
                                   estimators=25, kinds=kinds))
    return out


@pytest.mark.parametrize("bundle", sorted(BUNDLES))
def test_trained_predictors_checksum_and_predict_alike(bundles, bundle):
    (cp, gp), (jcp, jgp) = bundles[bundle]
    assert predictor_checksum(cp, gp) == jax_predictor_checksum(jcp, jgp)
    for p, j in ((cp, jcp), (gp, jgp)):
        assert predictor_checksum(p) == jax_predictor_checksum(j)
    # a bundle prices the kinds it has members for
    types = (jt.LinearOp, jt.ConvOp) + ((jt.AttnOp, jt.SSMOp)
                                        if BUNDLES[bundle][0] == 1 else ())
    ops = [op for op in JAX_OPS if isinstance(op, types)]
    port_ops = [to_port(op) for op in ops]
    for p, j in ((cp, jcp), (gp, jgp)):
        assert np.array_equal(p.predict(port_ops), j.predict(ops))
        # the predictors' error against the simulator, scored alike
        backend = p.linear.backend
        true = measure_ops(port_ops, "moto2022", backend, seed=1)
        assert np.array_equal(
            true, jax_measure_ops(ops, "moto2022", backend, seed=1))
        assert mape(p.predict(port_ops), true) == \
            jax_mape(j.predict(ops), true)


def _stack_global(module, name, call=False):
    """A protocol-4 pickle that resolves `module`.`name` (a dotted name is
    looked up attribute by attribute) and, with `call`, calls it."""
    def short(text):
        return b"\x8c" + bytes([len(text)]) + text.encode()
    body = b"\x80\x04" + short(module) + short(name) + b"\x93"
    return body + (b")R" if call else b"") + b"."


#: pickles a predictor cache file must never resolve, let alone call
FOREIGN_PICKLES = {
    "another package's class":
        pickle.dumps(collections.OrderedDict(a=1)),
    "os.system": b"cos\nsystem\n(S'true'\ntR.",
    "builtins.getattr": b"cbuiltins\ngetattr\n.",
    "numpy.load": _stack_global("numpy", "load"),
    "os through numpy.f2py": _stack_global("numpy.f2py", "os.getpid",
                                           call=True),
    "torch through the port's api": _stack_global("repro_torch.api",
                                                  "torch.load"),
    "a method of the port's class": _stack_global(
        "repro_torch.core.predictor.train", "LatencyPredictor.load"),
}


def test_a_saved_predictor_loads_alike_and_a_foreign_pickle_does_not(
        bundles, tmp_path):
    (cp, gp), _ = bundles["cpu3 linear+conv"]
    path = tmp_path / "gpu_linear.pkl"
    gp.linear.save(path)
    back = LatencyPredictor.load(path)
    assert predictor_checksum(back) == predictor_checksum(gp.linear)
    linear = [to_port(op) for op in JAX_OPS if isinstance(op, jt.LinearOp)]
    assert np.array_equal(back.predict(linear), gp.linear.predict(linear))
    # a pickle naming any global but the predictor's own few is refused
    # before that global's module is imported or anything is called
    for what, blob in FOREIGN_PICKLES.items():
        bad = tmp_path / "foreign.pkl"
        bad.write_bytes(blob)
        with pytest.raises(pickle.UnpicklingError, match="may not name"):
            LatencyPredictor.load(bad)


# ----------------------------------------------------------- partitioner
def _channel_ops():
    return [op for op in JAX_OPS if isinstance(op, (jt.LinearOp, jt.ConvOp))
            and op.C_out > 0][:80]


def _axis_ops():
    return [op for op in JAX_OPS
            if isinstance(op, (jt.AttnOp, jt.SSMOp))][:60]


@pytest.mark.parametrize("mechanism", list(SyncMechanism))
@pytest.mark.parametrize("step", [8, 32])
def test_channel_partitions_are_the_reference_decisions(bundles, mechanism,
                                                        step):
    (cp, gp), (jcp, jgp) = bundles["cpu3 linear+conv"]
    ops = _channel_ops()
    port_ops = [to_port(op) for op in ops]
    jm = JaxSync(mechanism.value)
    got = optimal_partition_batch(port_ops, cp, gp, mechanism=mechanism,
                                  step=step)
    want = jax_optimal_partition_batch(ops, jcp, jgp, mechanism=jm,
                                       step=step)
    assert [decision_to_json(d) for d in got] == \
        [jax_decision_to_json(d) for d in want]
    got = grid_search_partition_batch(port_ops, "moto2022", 3,
                                      mechanism=mechanism, step=step)
    want = jax_grid_search_partition_batch(ops, "moto2022", 3, mechanism=jm,
                                           step=step)
    assert [decision_to_json(d) for d in got] == \
        [jax_decision_to_json(d) for d in want]
    assert np.array_equal(
        realized_latency_us_batch(got, "moto2022", 3, mechanism=mechanism),
        jax_realized_latency_us_batch(want, "moto2022", 3, mechanism=jm))
    assert np.array_equal(
        speedup_vs_gpu_batch(got, "moto2022", 3, mechanism=mechanism),
        jax_speedup_vs_gpu_batch(want, "moto2022", 3, mechanism=jm))
    # the one-op spellings
    for op, jop in list(zip(port_ops, ops))[:4]:
        one = grid_search_partition(op, "moto2022", 3, mechanism=mechanism,
                                    step=step)
        jone = jax_grid_search_partition(jop, "moto2022", 3, mechanism=jm,
                                         step=step)
        assert decision_to_json(one) == jax_decision_to_json(jone)
        assert realized_latency_us(one, "moto2022", 3,
                                   mechanism=mechanism) == \
            jax_realized_latency_us(jone, "moto2022", 3, mechanism=jm)
        assert speedup_vs_gpu(one, "moto2022", 3, mechanism=mechanism) == \
            jax_speedup_vs_gpu(jone, "moto2022", 3, mechanism=jm)


@pytest.mark.parametrize("mechanism", list(SyncMechanism))
def test_axis_partitions_are_the_reference_decisions(bundles, mechanism):
    jm = JaxSync(mechanism.value)
    (cp, gp), (jcp, jgp) = bundles["cpu1 all kinds"]
    ops = _axis_ops()
    port_ops = [to_port(op) for op in ops]
    got = axis_partition_batch(port_ops, cp, gp, mechanism=mechanism)
    want = jax_axis_partition_batch(ops, jcp, jgp, mechanism=jm)
    assert [decision_to_json(d) for d in got] == \
        [jax_decision_to_json(d) for d in want]
    assert {d.axis for d in got} >= {"none"}
    assert np.array_equal(
        axis_realized_latency_us_batch(got, "moto2022", 1,
                                       mechanism=mechanism),
        jax_axis_realized(want, "moto2022", 1, mechanism=jm))
    got = grid_axis_partition_batch(port_ops, "moto2022", 1,
                                    mechanism=mechanism)
    want = jax_grid_axis_partition_batch(ops, "moto2022", 1, mechanism=jm)
    assert [decision_to_json(d) for d in got] == \
        [jax_decision_to_json(d) for d in want]


# --------------------------------------------------------------- planner
def _report_json(report, to_json):
    return {"device": report.device, "threads": report.threads,
            "totals": [report.baseline_us, report.individual_us,
                       report.end_to_end_us],
            "decisions": {k: to_json(d)
                          for k, d in sorted(report.decisions.items())},
            "opaque_us": dict(sorted(report.opaque_us.items()))}


GRAPHS = {"resnet18": (lambda: from_units(NETWORKS["resnet18"]()),
                       lambda: jax_from_units(JAX_NETWORKS["resnet18"]())),
          "tiny_hybrid": (lambda: from_model("tiny_hybrid", blocks=4),
                          lambda: jax_from_model("tiny_hybrid", blocks=4))}


@pytest.mark.parametrize("bundle", sorted(BUNDLES))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plan_graph_reports_are_the_reference_reports(bundles, graph,
                                                      bundle):
    (cp, gp), (jcp, jgp) = bundles[bundle]
    make, jax_make = GRAPHS[graph]
    threads = BUNDLES[bundle][0]
    got = plan_graph(make(), cp, gp, threads=threads)
    want = jax_plan_graph(jax_make(), jcp, jgp, threads=threads)
    assert _report_json(got, decision_to_json) == \
        _report_json(want, jax_decision_to_json)
    if graph == "tiny_hybrid":
        # decode nodes are priced over their typed axes only by a bundle
        # with their members; the plain bundle charges them opaquely
        assert bool(got.opaque_us) == (bundle == "cpu3 linear+conv")


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_grid_plan_graph_reports_are_the_reference_reports(graph):
    make, jax_make = GRAPHS[graph]
    got = grid_plan_graph(make(), "pixel5", 3)
    want = jax_grid_plan_graph(jax_make(), "pixel5", 3)
    assert _report_json(got, decision_to_json) == \
        _report_json(want, jax_decision_to_json)


@pytest.mark.parametrize("name", ["resnet18", "vgg16"])
def test_plan_graph_on_a_unit_chain_is_plan_network_bit_for_bit(bundles,
                                                                name):
    (cp, gp), (jcp, jgp) = bundles["cpu3 linear+conv"]
    units = NETWORKS[name]()
    net = plan_network(units, cp, gp, threads=3)
    graph = plan_graph(from_units(units), cp, gp, threads=3)
    assert (net.baseline_us, net.individual_us, net.end_to_end_us) == \
        (graph.baseline_us, graph.individual_us, graph.end_to_end_us)
    split_ids = [n.id for n in from_units(units) if n.op is not None]
    assert [graph.decisions[i] for i in split_ids] == net.decisions
    ref = jax_plan_network(JAX_NETWORKS[name](), jcp, jgp, threads=3)
    assert (net.baseline_us, net.individual_us, net.end_to_end_us) == \
        (ref.baseline_us, ref.individual_us, ref.end_to_end_us)
    assert [decision_to_json(d) for d in net.decisions] == \
        [jax_decision_to_json(d) for d in ref.decisions]


# ------------------------------------------------------------ plan cache
def _tamper(path, how):
    doc = json.loads(path.read_text())
    if how == "garbage":
        path.write_text("{not json")
        return
    if how == "split":                 # c_gpu + c_cpu != C_out
        dec = doc["schedule"][0]["decision"]
        dec["c_gpu"] += 1
    elif how == "stale":               # another seed's provenance
        doc["provenance"]["seed"] = 7
    path.write_text(json.dumps(doc, indent=1))


@pytest.mark.parametrize("how", ["none", "garbage", "split", "stale"])
def test_plan_cache_hits_misses_and_rejections_match_the_reference(
        bundles, tmp_path, how):
    """The same cache file, tampered or not, is a hit or a miss in both
    caches, and a rejected one is logged under the same rule id."""
    (cp, gp), _ = bundles["cpu3 linear+conv"]
    units = NETWORKS["resnet18"]()
    cache = PlanCache(tmp_path)
    plan = plan_graph_cached(from_units(units), cp, gp, threads=3,
                             cache=cache)
    assert (cache.hits, cache.misses) == (0, 1)
    path = cache.path_for(plan.provenance)
    _tamper(path, how)
    jax_cache = JaxPlanCache(tmp_path)
    rejections.clear()
    jax_rejections.clear()
    got = cache.get(plan.provenance)
    want = jax_cache.get(JaxProvenance(**plan.provenance.to_json()))
    assert (got is None) == (want is None) == (how != "none")
    assert (cache.hits, cache.misses) == (1, 1) if how == "none" else \
        (cache.hits, cache.misses) == (0, 2)
    assert (jax_cache.hits, jax_cache.misses) == \
        ((1, 0) if how == "none" else (0, 1))
    assert rejections.counts() == jax_rejections.counts()
    assert [e[:2] for e in rejections.entries()] == \
        [e[:2] for e in jax_rejections.entries()]
    if how != "none":
        assert rejections.total() == 1
    rejections.clear()
    jax_rejections.clear()


#: every cached planner by the name both packages give it, less `_cached`
CACHED = ("plan_graph", "plan_network", "partition_ops", "grid_plan_graph",
          "grid_plan_network", "grid_partition_ops")


def _plan_cached(entry, module, from_units_, units, bundle, cache):
    fn = getattr(module, f"{entry}_cached")
    ops = [u[1] for u in units if u[0] != "pool"]
    network = {"graph": from_units_(units), "network": units,
               "ops": ops}[entry.rsplit("_", 1)[1]]
    if entry.startswith("grid_"):
        return fn(network, "moto2022", 3, cache=cache)
    if entry == "partition_ops":
        return fn(network, *bundle, cache=cache)
    return fn(network, *bundle, threads=3, cache=cache)


@pytest.mark.parametrize("entry", CACHED)
def test_cached_planners_write_the_reference_plan_files(bundles, tmp_path,
                                                        entry):
    """Each cached planner writes the reference's file under the
    reference's key, returns what the reference's returns, and a second
    call is a warm hit, in its own cache and in the reference's."""
    (cp, gp), (jcp, jgp) = bundles["cpu3 linear+conv"]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"

    def port(cache):
        return _plan_cached(entry, cache_module, from_units,
                            NETWORKS["resnet18"](), (cp, gp), cache)

    cache, jax_cache = PlanCache(port_dir), JaxPlanCache(ref_dir)
    got = port(cache)
    want = _plan_cached(entry, jax_cache_module, jax_from_units,
                        JAX_NETWORKS["resnet18"](), (jcp, jgp), jax_cache)
    if isinstance(got, list):           # the decision-returning spellings
        assert [decision_to_json(d) for d in got] == \
            [jax_decision_to_json(d) for d in want]
    else:
        assert got.to_json() == want.to_json()
    assert len(cache.keys()) == 1
    assert cache.keys() == jax_cache.keys()
    name = f"{cache.keys()[0]}.json"
    assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes()
    assert (cache.hits, cache.misses) == (0, 1)
    port(cache)
    assert (cache.hits, cache.misses) == (1, 1)
    other = PlanCache(ref_dir)
    assert port(other) == got
    assert (other.hits, other.misses) == (1, 0)
