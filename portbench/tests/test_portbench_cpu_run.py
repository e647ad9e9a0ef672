"""A whole run at a size a test can hold, on the CPU: the harness's look
for a card skipped, everything else as on the card.  A sound run is
correct; the control and each fault the cell can have are not."""
import math

import pytest
import torch

from portbench import manifest, run

DOC = manifest.load()
CELL = manifest.cell(DOC, "vgg16.coexec-b1")

MIX = {"batch": 1, "pool": 3, "trace_calls": 2, "check_calls": 4}
#: at this size the program's plain CPU path computes what the reference
#: does to ~1e-6, and one TF32 pass misses by ~1e-3
LIMITS = {"out_err": 1e-4}


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    """A VGG-like chain at 32x32: a conv split over the two groups, a
    conv that takes Winograd, two max pools and two linear layers."""
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
    sched = compiled.plan.to_json()["schedule"]
    assert sched[0]["decision"]["c_cpu"] and sched[0]["decision"]["c_gpu"]
    return {"name": "tiny", "driver": "plan", "artifact": "tiny.coexec.json",
            "dir": str(d), "dtype": "float32", "tf32": False}


def _run(config, seed=2**31 + 11, traced=False):
    return run.execute(DOC, CELL, seed, 0.3, traced, "cpu", config=config,
                       mix=MIX, limits=LIMITS)


def test_sound_run(config):
    res = _run(config)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"plan_requests_per_s", "plan_ms_p95",
                                   "setup_s"}


def test_same_seed_same_inputs(config):
    from portbench import traffic
    drv = [manifest.driver("plan").Driver(config, traffic.mix(MIX), "cpu")
           for _ in range(2)]
    for d in drv:
        d.prepare(2**33 + 1)
    assert torch.equal(drv[0].pool, drv[1].pool)
    assert all(torch.equal(drv[0].weights[k], drv[1].weights[k])
               for k in drv[0].weights)


def test_control_fails(config):
    from portbench import traffic
    drv = manifest.driver("plan").Driver(config, traffic.mix(MIX), "cpu")
    drv.prepare(5)
    run.window(drv, 0.3, lambda: None)
    program, control = drv.check(), drv.check(control=True)
    assert program["out_err"] <= LIMITS["out_err"]
    assert control["out_err"] > 3 * LIMITS["out_err"]


# ------------------------------------------------------------------ faults
def _plant(monkeypatch, fault):
    from repro_torch.core import coexec
    from repro_torch.kernels.winograd_conv import winograd_conv
    from repro_torch.runtime.executor import PlanExecutor

    if fault == "answer altered":
        real = PlanExecutor.run

        def altered(self, *a, **k):
            y, report = real(self, *a, **k)
            return y + 1e-3 * y.abs().max(), report
        monkeypatch.setattr(PlanExecutor, "run", altered)
    elif fault == "exchange left out":
        real = coexec.run_sides

        def one_side(*a, **k):
            parts, events = real(*a, **k)
            return [parts[0], torch.zeros_like(parts[1])], events
        monkeypatch.setattr(coexec, "run_sides", one_side)
    elif fault == "product unchanged":
        def unchanged(u, v, launch=None):
            return torch.zeros(u.shape[0], u.shape[1], v.shape[2],
                               dtype=u.dtype, device=u.device)
        monkeypatch.setattr(winograd_conv, "hadamard_matmul", unchanged)


@pytest.mark.parametrize("fault", ["answer altered", "exchange left out",
                                   "product unchanged"])
def test_faults_are_not_correct(config, monkeypatch, fault):
    _plant(monkeypatch, fault)
    res = _run(config)
    assert not res["correct"]


def test_a_failing_call_is_counted(config, monkeypatch):
    from repro_torch.runtime.executor import PlanExecutor

    calls = {"n": 0}
    real = PlanExecutor.run

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:             # the window's first call
            raise RuntimeError("planted")
        return real(self, *a, **k)
    monkeypatch.setattr(PlanExecutor, "run", flaky)
    res = _run(config)
    assert res["failed"] == 1 and not res["correct"]


def test_a_failed_request_misses_every_limit():
    from portbench.readers import percentile
    assert percentile([1.0] * 19 + [math.inf], 95) == 1.0
    assert percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf
