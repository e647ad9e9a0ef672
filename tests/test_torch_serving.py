"""The port's serving path against the reference's, on the CPU.

`ServingEngine` (greedy completions token for token, the mixed-length
padded batch, the decode-step accounting, drift and its alias, a shipped
plan executed with its records appended), `windowed_drift` and
`DriftMonitor` on seeded sequences, `poisson_requests`, and the
continuous scheduler: its greedy completions equal to each request served
alone and to the reference's, and its virtual-clock `SchedulerReport` and
the `FixedBatchReference` equal to the reference's field for field, with
both packages' portfolios compiled from the same small predictors.  Then
the port's own runs of the reference's two acceptance tests (the
scheduler beats the fixed batch; a throttle triggers a validated replan),
sampled decoding held to the softmax by a chi-square test (the two
packages draw different random bits), and `python -m repro_torch serve`
in both modes with jax and `repro` blocked.

Token-for-token cases run reduced codeqwen1.5-7b in fp32: bf16 sums round
differently in XLA and PyTorch, which can flip a greedy choice.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy import stats

import repro
from repro.core.predictor import sample_conv_ops as jax_sample_conv_ops
from repro.core.predictor import sample_linear_ops as jax_sample_linear_ops
from repro.core.predictor import train_predictor as jax_train_predictor
from repro.core.predictor.gbdt import GBDTParams as JaxGBDTParams
from repro.core.predictor.train import MuxPredictor as JaxMuxPredictor
from repro.measure.drift import DriftMonitor as JaxDriftMonitor
from repro.measure.drift import windowed_drift as jax_windowed_drift
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousScheduler as JaxContinuousScheduler
from repro.serving import FixedBatchReference as JaxFixedBatchReference
from repro.serving import Request as JaxRequest
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import poisson_requests as jax_poisson_requests

import repro_torch
from repro_torch.core.predictor import (GBDTParams, sample_conv_ops,
                                        sample_linear_ops, train_predictor)
from repro_torch.core.predictor.train import MuxPredictor
from repro_torch.measure import DriftMonitor, MeasurementStore, windowed_drift
from repro_torch.models import build_model, get_config, params_from_numpy
from repro_torch.serving import (ContinuousScheduler, FixedBatchReference,
                                 Request, SchedulerConfig, ServingEngine,
                                 ThrottleSim, poisson_requests, sample_tokens)

from test_torch_support import blocked_cli

CPU = "cpu"


@pytest.fixture(scope="module")
def gqa_model():
    """Reduced codeqwen1.5-7b in fp32, the reference's weights in both
    packages: (port cfg, model, params), (reference cfg, model, params)."""
    cfg = dataclasses.replace(get_config("codeqwen15_7b").reduced(),
                              dtype="float32")
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return (cfg, build_model(cfg), params), (jcfg, jmodel, jparams)


_FAST = dict(n_estimators=40, max_depth=6, learning_rate=0.2)


@pytest.fixture(scope="module")
def predictors():
    """The reference scheduler tests' small (cpu, gpu) predictor pair,
    trained by each package from the same data."""
    def train(sample_linear, sample_conv, train_pred, params, mux):
        lt, ct = sample_linear(250, seed=1), sample_conv(250, seed=1)
        p = params(**_FAST)
        gp = mux(train_pred(lt, "moto2022", "gpu", whitebox=True, params=p),
                 train_pred(ct, "moto2022", "gpu", whitebox=True, params=p))
        cp = mux(train_pred(lt, "moto2022", "cpu3", whitebox=False,
                            params=p),
                 train_pred(ct, "moto2022", "cpu3", whitebox=False,
                            params=p))
        return cp, gp
    return (train(sample_linear_ops, sample_conv_ops, train_predictor,
                  GBDTParams, MuxPredictor),
            train(jax_sample_linear_ops, jax_sample_conv_ops,
                  jax_train_predictor, JaxGBDTParams, JaxMuxPredictor))


@pytest.fixture(scope="module")
def plan_cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("plans")


def _portfolios(gqa_model, predictors, cache, buckets):
    (cfg, _, _), (jcfg, _, _) = gqa_model
    port = repro_torch.compile_portfolio(
        cfg, repro_torch.Target(device="moto2022"), buckets=buckets,
        cache=cache, predictors=predictors[0])
    ref = repro.compile_portfolio(
        jcfg, repro.Target(device="moto2022"), buckets=buckets,
        cache=cache / "jax", predictors=predictors[1])
    return port, ref


def _reqs(prompts, max_new, arrivals=None, temps=None, cls=Request):
    rng = np.random.default_rng(7)
    out = []
    for i, t in enumerate(prompts):
        out.append(cls(
            rid=i, prompt=rng.integers(1, 256, t).astype(np.int32),
            max_new_tokens=max_new[i] if isinstance(max_new, (list, tuple))
            else max_new,
            temperature=0.0 if temps is None else temps[i],
            arrival_s=0.0 if arrivals is None else arrivals[i]))
    return out


def _as_ref(reqs):
    return [JaxRequest(**dataclasses.asdict(r)) for r in reqs]


# ------------------------------------------------------------------ engine
def test_engine_greedy_completions_are_the_references(gqa_model):
    """Two batches of four (a left-padded mixed-length batch, then a
    smaller one), with per-request budgets: the same tokens as the
    reference's engine, and the same decode-step accounting."""
    (cfg, model, params), (jcfg, jmodel, jparams) = gqa_model
    reqs = _reqs(prompts=[3, 10, 5, 7, 2, 9], max_new=[5, 2, 6, 1, 4, 3])
    engine = ServingEngine(cfg, model, params, max_batch=4, max_len=32,
                           device=CPU)
    jengine = JaxServingEngine(jcfg, jmodel, jparams, max_batch=4,
                               max_len=32)
    got = engine.run(reqs)
    want = jengine.run(_as_ref(reqs))
    assert [(c.rid, c.tokens) for c in got] == \
        [(c.rid, c.tokens) for c in want]
    assert engine.last_batch_decode_steps == jengine.last_batch_decode_steps


def test_mixed_length_padded_batch_matches_alone(gqa_model):
    (cfg, model, params), _ = gqa_model
    reqs = _reqs(prompts=[3, 10], max_new=5)
    batched = ServingEngine(cfg, model, params, max_batch=2, max_len=32,
                            device=CPU).run(reqs)
    for r, c in zip(reqs, batched):
        solo = ServingEngine(cfg, model, params, max_batch=1, max_len=32,
                             device=CPU).run([r])[0]
        assert c.tokens == solo.tokens, f"request {r.rid} diverged"


def test_engine_decode_step_accounting(gqa_model):
    (cfg, model, params), _ = gqa_model
    engine = ServingEngine(cfg, model, params, max_batch=4, max_len=32,
                           device=CPU)
    engine.run(_reqs(prompts=[4, 3, 2, 5], max_new=[1, 4, 1, 1]))
    assert engine.last_batch_decode_steps == 3
    engine.run(_reqs(prompts=[4, 3], max_new=[1, 1]))
    assert engine.last_batch_decode_steps == 0


def test_engine_windowed_drift_and_alias(gqa_model):
    (cfg, model, params), _ = gqa_model
    engine = ServingEngine(cfg, model, params, device=CPU)
    assert engine.drift is None
    assert engine.drift_latest_vs_first is None
    engine._fidelity_log = [5.0] + [0.1] * 8
    assert abs(engine.drift) < 0.05
    assert engine.drift_latest_vs_first == pytest.approx(-4.9)
    engine._fidelity_log = [0.1] * 6 + [0.8] * 4
    assert engine.drift == pytest.approx(0.7)


def test_engine_refuses_what_it_cannot_serve(gqa_model):
    (cfg, model, params), _ = gqa_model
    with pytest.raises(TypeError, match="CompiledNetwork"):
        ServingEngine(cfg, model, params, compiled=object(), device=CPU)
    with pytest.raises(TypeError, match="CoexecPlan"):
        ServingEngine(cfg, model, params, coexec_plan=object(), device=CPU)
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(cfg, model, params, compiled=object(),
                      coexec_plan=object(), device=CPU)
    with pytest.raises(ValueError, match="without a compiled network"):
        ServingEngine(cfg, model, params, device=CPU).execute_plan()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(cfg, model, params)


def test_engine_executes_a_shipped_plan_and_records_it(gqa_model,
                                                       predictors,
                                                       plan_cache_dir,
                                                       tmp_path):
    (cfg, model, params), _ = gqa_model
    port, _ = _portfolios(gqa_model, predictors, plan_cache_dir,
                          buckets=((1, 32),))
    compiled = port.entries[port.buckets[0]]
    store = tmp_path / "measurements"
    engine = ServingEngine(cfg, model, params, compiled=compiled,
                           measurement_store=store, device=CPU)
    assert engine.plan_executor is compiled.executor(device=CPU)
    y, report = engine.execute_plan()
    assert tuple(y.shape) == (1, cfg.d_model)
    assert bool(torch.isfinite(y).all())
    assert report.split_capable and report is engine.last_execution_report
    engine.execute_plan()
    assert engine.drift is not None
    assert len(MeasurementStore(store).load(compiled.key)) == \
        2 * len(report.timings)
    # a bare plan executes the same way on a fresh executor
    bare = ServingEngine(cfg, model, params, coexec_plan=compiled.plan,
                         device=CPU)
    y2, _ = bare.execute_plan()
    assert torch.equal(y, y2)


# -------------------------------------------------------------------- drift
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_drift_and_monitor_are_the_references(seed):
    rng = np.random.default_rng(seed)
    values = list(np.concatenate([rng.normal(0.0, 0.1, 12),
                                  rng.normal(0.6, 0.2, 12),
                                  rng.normal(0.05, 0.1, 12)]))
    for window, baseline in ((4, 4), (2, 6), (6, 2)):
        for n in range(len(values) + 1):
            assert windowed_drift(values[:n], window=window,
                                  baseline=baseline) == \
                jax_windowed_drift(values[:n], window=window,
                                   baseline=baseline)
    kw = dict(threshold=0.3, hysteresis=0.1, window=3, baseline=3,
              cooldown=4)
    mon, ref = DriftMonitor(**kw), JaxDriftMonitor(**kw)
    fired = []
    for i, v in enumerate(values):
        got = mon.observe(v)
        assert got == ref.observe(v)
        assert (mon.armed, mon.drift) == (ref.armed, ref.drift)
        if got:
            fired.append(i)
        if i == 30:
            mon.reset()
            ref.reset()
    assert fired, "the seeded shift never fired the monitor"


# ------------------------------------------------------------------ traffic
def test_poisson_requests_are_the_references():
    kw = dict(rate=100.0, vocab_size=64, prompt_lens=(2, 5, 9),
              max_new=(3, 7), temperatures=(0.0, 0.7), seed=3)
    got, want = poisson_requests(40, **kw), jax_poisson_requests(40, **kw)
    assert len(got) == len(want) == 40
    for x, y in zip(got, want):
        assert (x.rid, x.arrival_s, x.max_new_tokens, x.temperature) == \
            (y.rid, y.arrival_s, y.max_new_tokens, y.temperature)
        np.testing.assert_array_equal(x.prompt, y.prompt)
    assert [r.arrival_s for r in got] == sorted(r.arrival_s for r in got)


# ---------------------------------------------------------------- scheduler
def test_scheduler_matches_solo_greedy(gqa_model):
    (cfg, model, params), _ = gqa_model
    reqs = _reqs(prompts=[3, 7, 2, 9, 5], max_new=[4, 2, 5, 3, 4],
                 arrivals=[0.0, 0.0, 0.002, 0.004, 0.01])
    rep = ContinuousScheduler(
        cfg, model, params, device=CPU,
        config=SchedulerConfig(max_batch=2, max_len=32)).run(reqs)
    got = {c.rid: c.tokens for c in rep.completions}
    assert sorted(got) == [0, 1, 2, 3, 4]
    for r in reqs:
        solo = ServingEngine(cfg, model, params, max_batch=1, max_len=32,
                             device=CPU)
        want = solo.run([dataclasses.replace(r, arrival_s=0.0)])[0].tokens
        assert got[r.rid] == want, f"request {r.rid} diverged"
    assert rep.total_tokens == sum(len(t) for t in got.values())
    for s in rep.stats:
        assert s.ttft_s > 0.0 and s.latency_s >= s.ttft_s


def test_scheduler_rejects_non_slotted_models_and_long_requests(gqa_model):
    class Recurrent:                      # no per-slot position support
        per_slot_pos = False

    with pytest.raises(ValueError, match="per-slot position"):
        ContinuousScheduler(None, Recurrent(), params=None, device=CPU)
    (cfg, model, params), _ = gqa_model
    sched = ContinuousScheduler(cfg, model, params, device=CPU,
                                config=SchedulerConfig(max_len=16))
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.run(_reqs(prompts=[14], max_new=8))
    with pytest.raises(ValueError, match="unknown clock"):
        SchedulerConfig(clock="sundial")


def test_virtual_clock_reports_are_the_references(gqa_model, predictors,
                                                  plan_cache_dir):
    """Greedy Poisson traffic through both packages' schedulers over
    portfolios compiled from the same predictors, no plan executions: the
    same completions, token for token, and the same report, field for
    field; the fixed-batch reference's report as well."""
    (cfg, model, params), (jcfg, jmodel, jparams) = gqa_model
    buckets = ((1, 32), (2, 32), (4, 32))
    port, ref = _portfolios(gqa_model, predictors, plan_cache_dir, buckets)
    assert port.to_json() == ref.to_json()
    cost = port.select(4, 32)[1].plan.end_to_end_us * 1e-6
    reqs = poisson_requests(40, rate=0.33 / cost,
                            vocab_size=cfg.vocab_size,
                            prompt_lens=(2, 4, 12), max_new=(2, 4),
                            temperatures=(0.0,), seed=11)
    conf = dict(max_batch=4, max_len=32, fidelity_every=10**9)
    got = ContinuousScheduler(cfg, model, params, portfolio=port, device=CPU,
                              config=SchedulerConfig(**conf)).run(reqs)
    want = JaxContinuousScheduler(jcfg, jmodel, jparams, portfolio=ref,
                                  config=JaxSchedulerConfig(**conf)
                                  ).run(_as_ref(reqs))
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert [(c.rid, c.tokens) for c in got.completions] == \
        [(c.rid, c.tokens) for c in want.completions]
    assert got.bucket_switches > 0
    fixed = FixedBatchReference(port.select(4, 32)[1], max_batch=4)
    jfixed = JaxFixedBatchReference(ref.select(4, 32)[1], max_batch=4)
    assert fixed.run(reqs).to_json() == jfixed.run(_as_ref(reqs)).to_json()


# -------------------------------------------------------- serving acceptance
def test_scheduler_beats_fixed_batch_reference(gqa_model, predictors,
                                               plan_cache_dir):
    """The reference's acceptance test on the port: at the same arrival
    rate the portfolio scheduler wins both p99 latency and tokens/s
    against the fixed-batch reference served by the largest plan."""
    (cfg, model, params), _ = gqa_model
    pf, _ = _portfolios(gqa_model, predictors, plan_cache_dir,
                        buckets=((1, 32), (2, 32), (4, 32)))
    _, largest = pf.select(4, 32)
    rate = 0.33 / (largest.plan.end_to_end_us * 1e-6)
    reqs = poisson_requests(200, rate=rate, vocab_size=cfg.vocab_size,
                            prompt_lens=(2, 4, 12), max_new=(2, 4),
                            temperatures=(0.0,), seed=11)
    srep = ContinuousScheduler(
        cfg, model, params, portfolio=pf, device=CPU,
        config=SchedulerConfig(max_batch=4, max_len=32,
                               fidelity_every=10**9)).run(reqs)
    frep = FixedBatchReference(largest, max_batch=4).run(reqs)
    assert srep.bucket_switches > 0
    assert len(srep.bucket_steps) >= 2
    assert srep.latency_p(99) < frep.latency_p(99)
    assert srep.tokens_per_s > frep.tokens_per_s


def test_throttle_triggers_validated_replan(gqa_model, predictors,
                                            plan_cache_dir, tmp_path):
    """The reference's acceptance test on the port: a simulated throttle
    drives the bucket's drift over threshold, the scheduler replans in
    place (plans executed on the CPU), and the committed plan's fidelity
    error is lower than the trailing pre-replan window's."""
    (cfg, model, params), _ = gqa_model
    pf, _ = _portfolios(gqa_model, predictors, plan_cache_dir,
                        buckets=((2, 32),))
    bucket = pf.buckets[0]
    old_key = pf.entries[bucket].key
    cost = pf.entries[bucket].plan.end_to_end_us * 1e-6
    reqs = poisson_requests(48, rate=0.1 / cost, vocab_size=cfg.vocab_size,
                            prompt_lens=(2, 4, 12), max_new=(2, 4),
                            temperatures=(0.0,), seed=23)
    sched = ContinuousScheduler(
        cfg, model, params, portfolio=pf, device=CPU,
        measurement_store=tmp_path / "measurements",
        plan_cache=plan_cache_dir,
        config=SchedulerConfig(max_batch=2, max_len=32, fidelity_every=4,
                               fidelity_window=4, drift_cooldown=2),
        throttle=ThrottleSim(at_s=100 * cost, scale=2.5))
    rep = sched.run(reqs)
    assert rep.replan_events, "throttle never triggered a replan"
    ev = rep.replan_events[0]
    assert ev.post_fidelity is not None
    assert ev.post_fidelity < ev.pre_fidelity
    assert ev.new_key != ev.old_key
    new = pf.entries[bucket]
    assert new.key != old_key
    assert new.plan.provenance.calibration != ""
    assert rep.to_json()["replan_events"][0]["bucket"] == bucket.tag
    assert MeasurementStore(tmp_path / "measurements").load(old_key)


# ------------------------------------------------------------------ sampling
def test_sampled_tokens_follow_the_softmax():
    """Rows at temperature 0.7 draw from softmax(logits / 0.7): a
    chi-square test over 20000 draws; greedy rows stay greedy."""
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, 0.2])
    n, temp = 20000, 0.7
    gen = torch.Generator().manual_seed(5)
    rows = logits.expand(n, -1).clone()
    temps = np.full(n, temp, np.float32)
    temps[:100] = 0.0
    tok, gen2 = sample_tokens(gen, rows, temps)
    assert gen2 is gen and tok.dtype == torch.int32
    assert (tok[:100] == 4).all()              # argmax
    counts = np.bincount(tok[100:].numpy(), minlength=6)
    want = torch.softmax(logits / temp, 0).numpy() * (n - 100)
    chi2 = float(((counts - want) ** 2 / want).sum())
    assert chi2 < stats.chi2.ppf(1 - 1e-4, df=5), (counts, want)


def test_all_greedy_batches_leave_the_generator_untouched():
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    logits = torch.randn(3, 11, generator=torch.Generator().manual_seed(1))
    tok, _ = sample_tokens(gen, logits, [0.0, 0.0, -1.0])
    assert torch.equal(tok, logits.argmax(-1).to(torch.int32))
    assert torch.equal(gen.get_state(), state)
    tok, _ = sample_tokens(gen, logits, 0.0)       # a scalar temperature
    assert torch.equal(gen.get_state(), state)
    sample_tokens(gen, logits, [0.0, 0.5, 0.0])
    assert not torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------- CLI
def test_serve_cli_fixed_batch_on_the_cpu(tmp_path):
    out = blocked_cli(["serve", "--arch", "codeqwen15_7b", "--reduced",
                       "--torch-device", "cpu", "--requests", "6",
                       "--max-new", "5"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "6 completions, 30 tokens" in out.stdout
    assert "tok/s on cpu" in out.stdout


def test_serve_cli_scheduler_on_the_cpu(tmp_path):
    out = blocked_cli(["serve", "--arch", "codeqwen15_7b", "--reduced",
                       "--torch-device", "cpu", "--arrivals", "poisson",
                       "--requests", "8", "--portfolio", "pf.json",
                       "--samples", "120", "--estimators", "25",
                       "--fidelity-every", "4", "--throttle-at", "0.0"],
                      tmp_path)
    assert out.returncode == 0, out.stderr
    assert "wrote pf.json" in out.stdout
    assert "served 8 requests" in out.stdout and "bucket switches" in \
        out.stdout
    assert "tok/s on cpu" in out.stdout
    assert list((tmp_path / "reports/measurements").glob("*.jsonl"))
    # the saved portfolio serves again, loaded (it cannot replan)
    again = blocked_cli(["serve", "--arch", "codeqwen15_7b", "--reduced",
                         "--torch-device", "cpu", "--arrivals", "poisson",
                         "--requests", "4", "--portfolio", "pf.json"],
                        tmp_path)
    assert again.returncode == 0, again.stderr
    assert "cannot replan" in again.stdout


def test_serve_cli_refuses_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: serve would run there")
    out = blocked_cli(["serve", "--arch", "codeqwen15_7b", "--reduced"],
                      tmp_path)
    assert out.returncode == 2
    assert "CUDA is not available" in out.stderr
    assert "completions" not in out.stdout
