"""On the card, at the published widths and depth: zamba2-7b prefilled
with 4 x 2048 tokens and then decoded 8 greedy steps through its caches
agrees at every step with the plain reference's full forward over the
same 2056 tokens, within the cell's `logit_err` limit; and each planted
fault of the CPU tests reads over that limit."""
import pytest

from portbench import manifest, traffic
from test_portbench_zamba2 import FAULTS, _plant

CELL = "zamba2-7b.prefill"
PROMPT, STEPS = 2048, 8


@pytest.mark.cuda
def test_prefill_then_decode_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    errs = prefill_then_decode(2**31 + 32)
    limit = manifest.limits(CELL)["logit_err"]
    assert max(errs) <= limit, errs


def prefill_then_decode(seed: int):
    """Each step's logit_err: the prefill's last position, then each
    decode step's, against the reference at those positions."""
    import numpy as np
    import torch

    from portbench.compare import rel_err
    from portbench.reference import zamba2

    config = manifest.config(manifest.cell(manifest.load(), CELL)["config"])
    mix = traffic.mix(manifest.traffic(
        manifest.cell(manifest.load(), CELL)["traffic"]))
    drv = manifest.driver(config["driver"]).Driver(config, mix, "cuda")
    drv.prepare(seed)
    model, params, weights = drv.model, drv.params, drv.weights
    drv.release()
    rng = np.random.default_rng(traffic.subseed(seed, 5))
    tokens = torch.from_numpy(rng.integers(
        0, config["vocab_size"], (mix["batch"], PROMPT))).to("cuda")
    cache = model.init_cache(mix["batch"], PROMPT + STEPS, device="cuda")
    with torch.no_grad():
        logits, cache = model.prefill(params, tokens, cache)
        outs, seq = [logits], [tokens]
        for step in range(STEPS):
            tok = outs[-1].argmax(-1)[:, None]
            seq.append(tok)
            logits, cache = model.decode_step(params, tok, cache,
                                              PROMPT + step)
            outs.append(logits)
    ref = zamba2.logits(weights, config, torch.cat(seq, dim=1),
                        positions=range(PROMPT - 1, PROMPT + STEPS))
    return [rel_err(out.float(), ref[:, k]) for k, out in enumerate(outs)]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_is_over_the_limit_on_the_card(fault):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with pytest.MonkeyPatch.context() as mp:
        err = fault_reading(mp, fault, 2**31 + 33)
    assert err > manifest.limits(CELL)["logit_err"], err


def fault_reading(monkeypatch, fault: str, seed: int) -> float:
    """`logit_err` of one call of each prompt length with `fault`
    planted, at the cell's own configuration and mix."""
    _plant(monkeypatch, fault)
    doc = manifest.load()
    config = manifest.config(manifest.cell(doc, CELL)["config"])
    mix = traffic.mix(manifest.traffic(manifest.cell(doc, CELL)["traffic"]))
    drv = manifest.driver(config["driver"]).Driver(config, mix, "cuda")
    drv.prepare(seed)
    for i in range(len(drv.lengths)):
        drv.call(i, drv.make(i))
    drv.release()
    return drv.check()["logit_err"]
