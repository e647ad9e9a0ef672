"""On the card: each cell's run at its own size, briefly, is correct and
reads every metric it should; its control is not correct."""
import pytest

from portbench import manifest, run, traffic

DOC = manifest.load()


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_on_the_card(cell):
    _card()
    c = manifest.cell(DOC, cell)
    res = run.execute(DOC, c, 2**31 + 7, 3.0, True, "cuda")
    assert res["correct"], res["checks"]
    want = {m["name"] for m in manifest.metrics_for(DOC, cell, True)}
    assert set(res["metrics"]) == want
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_control_on_the_card_is_not_correct(cell):
    _card()
    import torch
    c = manifest.cell(DOC, cell)
    config = manifest.config(c["config"])
    run.set_tf32(config)
    drv = manifest.driver(config["driver"]).Driver(
        config, traffic.mix(manifest.traffic(c["traffic"])), "cuda")
    drv.prepare(2**32 + 3)
    drv.warmup()
    run.window(drv, 3.0, torch.cuda.synchronize)
    limits = manifest.limits(cell)
    control = drv.check(control=True)
    assert any(control[k] > limits[k] for k in limits)
