"""The port's measurement loop against the reference's, on the CPU.

Simulator records, training from records (with the random hyperparameter
search), the JSONL store, the calibrator, calibrated predictors, the
replanner and its `PlanDiff`, and `CompiledNetwork.record / recalibrate /
replan` and `python -m repro_torch calibrate` end to end.  Both packages
get the same inputs (records pass between them as JSON); every comparison
is `==` unless a tolerance is stated."""
import dataclasses
import json

import numpy as np
import pytest

import repro
import repro.core.types as jt
from repro.core.predictor.dataset import \
    sample_linear_ops as jax_sample_linear_ops
from repro.core.predictor.dataset import \
    training_from_records as jax_training_from_records
from repro.core.predictor.gbdt import GBDTParams as JaxGBDTParams
from repro.core.predictor.train import train_predictor as jax_train_predictor
from repro.core.simulator.measure import measure_records as jax_measure_records
from repro.measure import Calibrator as JaxCalibrator
from repro.measure import MeasurementRecord as JaxRecord
from repro.measure import MeasurementStore as JaxStore
from repro.measure import fidelity_error as jax_fidelity_error
from repro.measure.replan import replan as jax_replan
from repro.runtime.cache import PlanCache as JaxPlanCache
from repro.runtime.plan import calibration_version as jax_calibration_version
from repro.runtime.plan import predictor_checksum as jax_predictor_checksum
from repro.runtime.plan import train_mux_predictors as jax_train_mux

import repro_torch
import repro_torch.core.types as pt
from repro_torch.core.predictor.dataset import training_from_records
from repro_torch.core.predictor.gbdt import GBDTParams
from repro_torch.core.predictor.train import train_predictor
from repro_torch.core.simulator.measure import (measure_latency_us_batch,
                                                measure_records)
from repro_torch.measure import (Calibrator, CalibratedPredictor,
                                 MeasurementRecord, MeasurementStore,
                                 fidelity_error, record_for_op)
from repro_torch.measure.replan import replan
from repro_torch.runtime.cache import PlanCache
from repro_torch.runtime.plan import (calibration_version, predictor_checksum,
                                      train_mux_predictors)

from test_torch_support import blocked_cli, small_units, to_port

SMALL = dict(samples=120, estimators=25)


def port_units():
    return [(k, p if isinstance(p, int) else to_port(p))
            for k, p in small_units()]


def to_ref(records):
    """Port records as the reference's, through their JSON."""
    return [JaxRecord.from_json(json.loads(json.dumps(r.to_json())))
            for r in records]


def jsons(records):
    return [r.to_json() for r in records]


#: one op of each kind the simulator prices
OPS = [jt.LinearOp(64, 128, 256), jt.ConvOp(28, 28, 32, 64, 3, 1),
       jt.AttnOp(H=8, S=512, KV=4, hd=16), jt.SSMOp(T=1, H=8, hd=16, N=16),
       jt.LinearOp(1, 3584, 5696), jt.ConvOp(7, 7, 512, 512, 3, 1)]


# ------------------------------------------------------------ simulator
@pytest.mark.parametrize("device,backend,seed", [
    ("pixel5", "gpu", 3), ("moto2022", "cpu3", 0), ("moto2022", "cpu1", 7)])
def test_measure_records_are_the_reference_records(device, backend, seed):
    recs = measure_records([to_port(op) for op in OPS], device, backend,
                           seed=seed)
    assert jsons(recs) == jsons(jax_measure_records(OPS, device, backend,
                                                    seed=seed))
    walls = measure_latency_us_batch([to_port(op) for op in OPS], device,
                                     backend, seed=seed)
    assert [r.wall_us for r in recs] == [float(w) for w in walls]
    assert all(r.source == "simulator" and r.mode == "simulated"
               and r.pred_us > 0 for r in recs)


def _mixed_records():
    recs = [record_for_op(pt.LinearOp(1, 8, 8), wall_us=5.0, pred_us=1.0),
            record_for_op(pt.LinearOp(1, 8, 8), wall_us=0.0, pred_us=1.0),
            record_for_op(pt.LinearOp(1, 8, 8), wall_us=2.5, pred_us=1.0,
                          mode="coexec", source="executor"),
            MeasurementRecord(index=0, unit="pool", label="p", mode="pool",
                              c_fast=0, c_slow=0, chained_input=False,
                              gathered_output=True, wall_us=3.0,
                              pred_us=0.0),
            record_for_op(pt.ConvOp(8, 8, 4, 4, 3, 1), wall_us=7.0,
                          pred_us=1.0, mode="exclusive", source="executor")]
    return recs


@pytest.mark.parametrize("kind", [None, "linear", "conv"])
def test_training_from_records_drops_pools_coexec_and_nonpositive(kind):
    recs = _mixed_records()
    ops, y = training_from_records(recs, kind=kind)
    jops, jy = jax_training_from_records(to_ref(recs), kind=kind)
    assert [repr(op) for op in ops] == [repr(op) for op in jops]
    assert y.tolist() == jy.tolist()
    assert y.tolist() == {None: [5.0, 7.0], "linear": [5.0],
                          "conv": [7.0]}[kind]


def test_gbdt_params_random_draws_the_reference_params():
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        assert dataclasses.astuple(GBDTParams.random(rng)) == \
            dataclasses.astuple(JaxGBDTParams.random(jrng))


@pytest.mark.parametrize("backend,whitebox", [("gpu", True),
                                              ("cpu3", False)])
def test_train_predictor_on_records_with_hpo_is_the_reference(backend,
                                                              whitebox):
    """`y_us=` from simulator records, `hpo_trials=3`: the same chosen
    params, trees and checksum as the reference's."""
    jops = jax_sample_linear_ops(80, seed=3)
    ops = [to_port(op) for op in jops]
    recs = measure_records(ops, "moto2022", backend, seed=2)
    tr_ops, y = training_from_records(recs)
    jtr_ops, jy = jax_training_from_records(to_ref(recs))
    assert y.tolist() == jy.tolist()
    pred = train_predictor(tr_ops, "moto2022", backend, whitebox=whitebox,
                           y_us=y, hpo_trials=3, seed=1)
    jpred = jax_train_predictor(jtr_ops, "moto2022", backend,
                                whitebox=whitebox, y_us=jy, hpo_trials=3,
                                seed=1)
    assert sorted(map(str, pred.models)) == sorted(map(str, jpred.models))
    for k in pred.models:
        assert dataclasses.astuple(pred.models[k].params) == \
            dataclasses.astuple(jpred.models[k].params)
    assert predictor_checksum(pred) == jax_predictor_checksum(jpred)
    assert np.array_equal(pred.predict(ops[:9]), jpred.predict(jops[:9]))


# ---------------------------------------------------------------- store
@pytest.fixture(scope="module")
def small_compiled(tmp_path_factory):
    """The small network compiled by both packages with small predictors
    (one plan, one key), and two recorded CPU runs of the port."""
    root = tmp_path_factory.mktemp("loop")
    target = repro_torch.Target(device="moto2022", threads=3)
    port = repro_torch.compile(port_units(), target, cache=root / "plans",
                               **SMALL)
    ref = repro.compile(small_units(),
                        repro.Target(device="moto2022", threads=3),
                        cache=root / "jax_plans", **SMALL)
    assert port.to_json() == ref.to_json()
    store = MeasurementStore(root / "meas")
    reports = [port.record(store=store, device="cpu", warmup=False)
               for _ in range(2)]
    return port, ref, store, reports, root


def test_store_is_append_only_and_skips_corrupt_lines(small_compiled,
                                                      tmp_path):
    port, _, _, reports, _ = small_compiled
    store = MeasurementStore(tmp_path / "meas")
    store.append(reports[0])                      # an ExecutionReport
    assert store.keys() == [port.key]
    assert store.count(port.key) == len(reports[0].timings)
    store.append(reports[1].timings)              # or bare records
    loaded = store.load(port.key)
    assert jsons(loaded) == jsons(reports[0].timings + reports[1].timings)
    with open(store.path_for(port.key), "a") as f:
        f.write("{not json}\n\n")
    assert jsons(store.load(port.key)) == jsons(loaded)
    assert store.path_for(port.key).stem == PlanCache(
        tmp_path).path_for(port.provenance).stem
    unkeyed = record_for_op(pt.LinearOp(1, 8, 8), wall_us=1.0, pred_us=1.0)
    assert store.append([unkeyed]) == [store.path_for("unkeyed")]
    assert store.keys() == sorted([port.key, "unkeyed"])
    assert len(store.load_all()) == 2 * len(reports[0].timings) + 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_store_either_package_wrote_loads_in_the_other(small_compiled,
                                                         tmp_path, writer):
    port, _, _, reports, _ = small_compiled
    records = reports[0].timings + _mixed_records()
    if writer == "port":
        MeasurementStore(tmp_path).append(records, key="k")
        back = JaxStore(tmp_path).load("k")
    else:
        JaxStore(tmp_path).append(to_ref(records), key="k")
        back = MeasurementStore(tmp_path).load("k")
    assert jsons(back) == jsons(records)
    # and the two packages write the same lines
    MeasurementStore(tmp_path).append(records, key="port")
    JaxStore(tmp_path).append(to_ref(records), key="ref")
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()


# ----------------------------------------------------------- calibrator
def _synth_records(scale=40.0, slope=1.0, n=24, mode="exclusive",
                   kind="linear"):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        pred = float(rng.uniform(50, 5000))
        wall = scale * pred ** slope * float(np.exp(rng.normal(0, 0.05)))
        op = (pt.LinearOp(1, 8 * (i + 1), 16) if kind == "linear"
              else pt.ConvOp(8, 8, 4, 4 * (i + 1), 3, 1))
        recs.append(record_for_op(op, index=i, wall_us=wall, pred_us=pred,
                                  mode=mode, source="executor"))
    return recs


SYNTH = {
    "shift": lambda: _synth_records(scale=40.0),
    "identity": lambda: _synth_records(scale=1.0, n=12),
    "slope": lambda: _synth_records(scale=3.0, slope=0.6),
    "modes": lambda: (_synth_records(scale=10.0)
                      + _synth_records(scale=100.0, mode="coexec")),
    "kinds": lambda: (_synth_records(scale=5.0, slope=1.3, kind="conv")
                      + _synth_records(scale=0.2, n=2)),
}


@pytest.mark.parametrize("case", sorted(SYNTH))
def test_calibrator_fits_the_reference_calibrator(small_compiled, case):
    recs = SYNTH[case]()
    cal, jcal = Calibrator.fit(recs), JaxCalibrator.fit(to_ref(recs))
    assert cal.to_json() == jcal.to_json()
    assert cal.version == jcal.version
    assert cal.summary() == jcal.summary()
    assert fidelity_error(recs) == jax_fidelity_error(to_ref(recs))
    assert cal.fidelity_error(recs) == jcal.fidelity_error(to_ref(recs))
    assert cal.fidelity_error(recs) <= fidelity_error(recs)
    for kind, mode in (("linear", "exclusive"), ("linear", "coexec"),
                       ("conv", "*"), ("ssm", "*")):
        p = [0.0, 1.5, 250.0, 4e4]
        assert np.array_equal(cal.correct_us(kind, mode, p),
                              jcal.correct_us(kind, mode, p))
    # composing with an earlier calibrator, both ways round
    inner = Calibrator.fit(SYNTH["slope"]())
    jinner = JaxCalibrator.fit(to_ref(SYNTH["slope"]()))
    assert cal.compose(inner).to_json() == jcal.compose(jinner).to_json()
    assert inner.compose(cal).version == jinner.compose(jcal).version
    assert cal.compose(None) is cal


def test_calibrator_fits_the_port_records_as_the_reference(small_compiled):
    _, _, store, _, _ = small_compiled
    port = small_compiled[0]
    recs = store.load(port.key)
    cal, jcal = Calibrator.fit(recs), JaxCalibrator.fit(to_ref(recs))
    assert cal.to_json() == jcal.to_json() and cal.version == jcal.version
    assert cal.fidelity_error(recs) <= fidelity_error(recs)


def test_calibrator_refuses_zero_usable_records_as_the_reference():
    pool_only = [MeasurementRecord(
        index=0, unit="pool", label="p", mode="pool", c_fast=0, c_slow=0,
        chained_input=False, gathered_output=True, wall_us=3.0, pred_us=0.0)]
    with pytest.raises(ValueError) as port:
        Calibrator.fit(pool_only)
    with pytest.raises(ValueError) as ref:
        JaxCalibrator.fit(to_ref(pool_only))
    assert str(port.value) == str(ref.value)
    assert "zero usable" in str(port.value)


def test_calibrator_saves_and_loads_across_packages(tmp_path):
    cal = Calibrator.fit(SYNTH["modes"]())
    path = cal.save(tmp_path / "port.json")
    jcal = JaxCalibrator.fit(to_ref(SYNTH["modes"]()))
    jcal.save(tmp_path / "ref.json")
    assert path.read_bytes() == (tmp_path / "ref.json").read_bytes()
    back = Calibrator.load(tmp_path / "ref.json")
    assert back.corrections == cal.corrections
    assert back.version == JaxCalibrator.load(path).version == cal.version
    bad = cal.to_json() | {"schema_version": 2}
    with pytest.raises(ValueError, match="unsupported calibration schema"):
        Calibrator.from_json(bad)


@pytest.fixture(scope="module")
def mux_pairs():
    """Both packages' small predictor pairs (threads 3 linear+conv, and
    threads 1 with attention and ssm members)."""
    out = {}
    for threads, kinds in ((3, ("linear", "conv")),
                           (1, ("linear", "conv", "attention", "ssm"))):
        out[threads] = (train_mux_predictors("moto2022", threads, kinds=kinds,
                                             **SMALL),
                        jax_train_mux("moto2022", threads, kinds=kinds,
                                      **SMALL))
    return out


def test_calibrated_predictors_predict_and_checksum_as_the_reference(
        mux_pairs):
    (cp, gp), (jcp, jgp) = mux_pairs[1]
    recs = SYNTH["kinds"]() + _synth_records(scale=2.0, slope=0.8)
    cal, jcal = Calibrator.fit(recs), JaxCalibrator.fit(to_ref(recs))
    wrapped, jwrapped = cal.wrap(cp), jcal.wrap(jcp)
    assert isinstance(wrapped, CalibratedPredictor)
    assert wrapped.device == cp.device
    assert cal.wrap(wrapped).inner is cp              # never stacks
    assert wrapped.member("attention") is cp.member("attention")
    port_ops = [to_port(op) for op in OPS]
    assert np.array_equal(wrapped.predict(port_ops), jwrapped.predict(OPS))
    assert not np.array_equal(wrapped.predict(port_ops), cp.predict(port_ops))
    # checksum-transparent; the calibration keys plans through provenance
    assert predictor_checksum(wrapped, cal.wrap(gp)) == \
        predictor_checksum(cp, gp) == jax_predictor_checksum(jcp, jgp)
    assert calibration_version(wrapped, cal.wrap(gp)) == cal.version == \
        jax_calibration_version(jwrapped, jcal.wrap(jgp))
    assert calibration_version(cp, gp) == "" == jax_calibration_version(jcp)


# ------------------------------------------------------------- replan
def _replan_both(port, ref, records, root, tag):
    cal = Calibrator.fit(records)
    jcal = JaxCalibrator.fit(to_ref(records))
    new, diff = replan(port.plan, *port.predictors, cal,
                       cache=PlanCache(root / f"{tag}_plans"))
    jnew, jdiff = jax_replan(ref.plan, *ref.predictors, jcal,
                             cache=JaxPlanCache(root / f"{tag}_jax_plans"))
    assert new.to_json() == jnew.to_json()
    assert new.key == jnew.key != port.key
    assert new.provenance.calibration == cal.version
    assert diff.to_json() == jdiff.to_json()
    assert diff.summary() == jdiff.summary()
    return new, diff


def test_replan_on_the_port_cpu_records_is_the_reference_replan(
        small_compiled):
    port, ref, store, _, root = small_compiled
    new, diff = _replan_both(port, ref, store.load(port.key), root, "cpu")
    assert diff.predicted_gain_us >= 0.0
    assert diff.n_ops == len(port.plan.decisions)


def FORCING():
    """Synthetic records that move the planner: convs measured 100x
    faster than predicted, so the sync overhead outweighs a split of the
    small ones (a shift applied to both sides moves no split point, only
    the choice between co-execution and one side)."""
    return _synth_records(scale=0.01, kind="conv")


def test_replan_on_records_that_move_the_plan_is_the_reference_replan(
        small_compiled):
    port, ref, _, _, root = small_compiled
    new, diff = _replan_both(port, ref, FORCING(), root, "forced")
    assert diff.changes, "the forcing records should move a decision"
    assert diff.predicted_gain_us > 0.0
    changed = {c.index for c in diff.changes}
    old = port.plan.decisions
    moved = [i for i, (o, n) in enumerate(zip(old, new.decisions))
             if (o.c_cpu, o.c_gpu) != (n.c_cpu, n.c_gpu)]
    assert len(moved) == len(changed)


def test_a_replanned_plan_strict_loads_in_both_packages(small_compiled,
                                                        tmp_path):
    port, ref, _, _, root = small_compiled
    new, _ = _replan_both(port, ref, FORCING(), root, "load")
    compiled = repro_torch.CompiledNetwork(plan=new, target=port.target)
    path = compiled.save(tmp_path / "replanned.json")
    back = repro_torch.CompiledNetwork.load(path)
    jback = repro.CompiledNetwork.load(path)
    assert back.to_json() == jback.to_json() == compiled.to_json()
    assert back.provenance.calibration == jback.provenance.calibration != ""
    from repro.analysis import verify_path as jax_verify_path
    from repro_torch.analysis import verify_path
    kind, diags = verify_path(path)
    jkind, jdiags = jax_verify_path(path)
    assert (kind, [str(d) for d in diags]) == \
        (jkind, [str(d) for d in jdiags])


# ----------------------------------------------------- the facade, end to end
@pytest.mark.parametrize("network", ["small", "resnet18", "tiny_hybrid"])
def test_record_recalibrate_and_replan_end_to_end(mux_pairs, tmp_path,
                                                  network):
    """>= 2 recorded CPU executions -> recalibrate() does not increase the
    fidelity error; replan() lands under a new key with the old entry
    untouched, equals the reference's replan on the same records, warm-hits
    when repeated, and the replanned network runs."""
    threads = 1 if network == "tiny_hybrid" else 3
    (cp, gp), (jcp, jgp) = mux_pairs[threads]
    if network == "small":
        net, jnet = port_units(), small_units()
    elif network == "tiny_hybrid":
        from repro.graph.frontends import from_model as jax_from_model
        from repro_torch.graph.frontends import from_model
        net = from_model("tiny_hybrid", blocks=2, cache_len=512)
        jnet = jax_from_model("tiny_hybrid", blocks=2, cache_len=512)
    else:
        net = jnet = network
    cache = PlanCache(tmp_path / "plans")
    compiled = repro_torch.compile(
        net, repro_torch.Target(device="moto2022", threads=threads),
        predictors=(cp, gp), cache=cache)
    ref = repro.compile(jnet, repro.Target(device="moto2022",
                                           threads=threads),
                        predictors=(jcp, jgp), cache=tmp_path / "jax_plans")
    assert compiled.to_json() == ref.to_json()
    store = MeasurementStore(tmp_path / "meas")
    for _ in range(2):
        compiled.record(store=store, device="cpu", warmup=False)
    records = store.load(compiled.key)
    assert len(records) == 2 * len(compiled.plan.schedule)

    cal = compiled.recalibrate(store)
    assert compiled.calibration is cal
    assert cal.fidelity_error(records) <= fidelity_error(records)

    old_path = cache.path_for(compiled.provenance)
    old_bytes = old_path.read_bytes()
    recompiled, diff = compiled.replan(store=store, cache=cache)
    assert recompiled.calibration is cal and not recompiled.from_cache
    assert recompiled.key != compiled.key
    assert recompiled.provenance.calibration == cal.version
    assert old_path.read_bytes() == old_bytes
    assert cache.path_for(recompiled.provenance).exists()
    assert diff.old_key == compiled.key and diff.new_key == recompiled.key
    assert diff.predicted_gain_us >= -1e-9

    jstore = JaxStore(tmp_path / "meas")
    jcal = ref.recalibrate(jstore)
    jnew, jdiff = ref.replan(jcal, store=jstore, cache=tmp_path / "jax_plans")
    assert recompiled.to_json() == jnew.to_json()
    assert diff.to_json() == jdiff.to_json()

    again, diff2 = compiled.replan(cal, store=store, cache=cache)
    assert again.from_cache and again.key == recompiled.key
    assert diff2.to_json() == diff.to_json()
    rep = recompiled.profile(device="cpu", warmup=False)
    assert len(rep.timings) == len(compiled.plan.schedule)


def test_replan_and_recalibrate_refuse_as_the_reference(small_compiled,
                                                        tmp_path):
    port, ref, _, _, _ = small_compiled

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    fresh = repro_torch.CompiledNetwork(plan=port.plan, target=port.target,
                                        mode="predicted",
                                        predictors=port.predictors)
    jfresh = repro.CompiledNetwork(plan=ref.plan, target=ref.target,
                                   mode="predicted",
                                   predictors=ref.predictors)
    assert message(lambda: fresh.recalibrate(tmp_path / "empty")) == \
        message(lambda: jfresh.recalibrate(tmp_path / "empty"))
    loaded = repro_torch.CompiledNetwork.from_json(port.to_json())
    jloaded = repro.CompiledNetwork.from_json(ref.to_json())
    assert message(lambda: loaded.replan(cache=tmp_path)) == \
        message(lambda: jloaded.replan(cache=tmp_path))
    grid = repro_torch.compile(port_units(), port.target, mode="grid",
                               cache=tmp_path / "grid")
    jgrid = repro.compile(small_units(), ref.target, mode="grid",
                          cache=tmp_path / "jax_grid")
    assert message(lambda: grid.replan(cache=tmp_path)) == \
        message(lambda: jgrid.replan(cache=tmp_path))
    cal = Calibrator.fit(FORCING())
    with pytest.raises(ValueError, match="predictor-driven"):
        replan(grid.plan, *port.predictors, cal, cache=PlanCache(tmp_path))


# ------------------------------------------------------------------ CLI
def test_cli_calibrate_runs_without_jax_on_the_cpu(tmp_path):
    """`python -m repro_torch calibrate --torch-device cpu` with jax and
    `repro` kept from import: records, fits, replans and writes what the
    reference reads."""
    args = ["calibrate", "--network", "resnet18", "--device", "moto2022",
            "--threads", "3", "--samples", "120", "--estimators", "25",
            "--cache-dir", str(tmp_path / "plans"), "--store-dir",
            str(tmp_path / "meas"), "--save-calibration",
            str(tmp_path / "cal.json"), "--torch-device", "cpu", "--verbose"]
    proc = blocked_cli(args, tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("calibrate resnet18 on moto2022 (cpu3, "
                               "svm_poll): plan ")
    assert "(cache MISS (compiled)" in lines[0]
    assert sum(line.startswith("  run ") for line in lines) == 2
    assert any(line.startswith("  fidelity error ") for line in lines)
    assert any(line.startswith("plan diff: ") for line in lines)
    assert any(line.startswith("  new plan cached at ") for line in lines)
    cal = JaxCalibrator.load(tmp_path / "cal.json")
    key = lines[0].split("plan ")[1].split()[0]
    records = JaxStore(tmp_path / "meas").load(key)
    assert len(records) == 2 * 23
    assert JaxCalibrator.fit(records).version == cal.version
    assert f"calibrator {cal.version}: " in proc.stdout
    # the replanned plan in the shared cache loads in the reference
    new_path = lines[[i for i, line in enumerate(lines)
                      if line.startswith("  new plan cached at ")][0]]
    from repro.runtime.plan import CoexecPlan as JaxCoexecPlan
    plan = JaxCoexecPlan.load(new_path.split(" at ")[1])
    assert plan.provenance.calibration == cal.version


@pytest.mark.parametrize("args, message", [
    (["--mode", "grid"], "calibrate needs mode='predicted'"),
    (["--network", "resnet19"], "unknown network 'resnet19'"),
])
def test_cli_calibrate_refuses_bad_input_with_exit_2(args, message,
                                                     tmp_path):
    proc = blocked_cli(["calibrate", *args, "--cache-dir", str(tmp_path)],
                       tmp_path)
    assert proc.returncode == 2
    assert message in proc.stderr and "Traceback" not in proc.stderr
