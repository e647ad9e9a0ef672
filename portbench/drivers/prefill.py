"""A Zamba2 model's prefill served through the port's `ServingEngine`,
one bucket of prompts a call.

The system under test is `repro_torch`'s published Zamba2
(`models/zamba2_published.py`) built from the configuration's own keys
(`Zamba2Layout.from_hf`), and `ServingEngine(layout, model, params,
max_batch=B, max_len=S).run(requests)`.  The benchmark draws the weights
from the seed on the card (`reference/zamba2.init`, the published init
rules), hands them to the program and keeps its own copy on the host for
the reference, so the card holds what a deployment would.  Call i sends `batch` prompts of
the length `serving.prompt_lengths[i % len]` names, drawn from the seed
over the vocabulary (a pool of `pool` buckets sent in turn, each slot
keeping its length), each with `serving.max_new_tokens` (1): the call
returns when the greedy tokens are on the host, so its time is the
bucket's time to first token.  Its counters are the model's
`last_prefill_counts` (`ssd_calls`, `shared_applications`).

The check holds, for each prompt length, a reservoir sample drawn from
the seed of the window's calls, and compares the engine's
`last_prefill_logits` of each held call, (B, V), with the plain fp32
reference (`reference/zamba2.py`) on the benchmark's own weights and the
same prompts:
`logit_err` is the largest |logits - reference| over the reference's
largest |logit|, worst call first.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from portbench import counts_zamba2, traffic
from portbench.compare import rel_err
from portbench.drivers.plan import Reservoir
from portbench.reference import zamba2
from portbench.reference.precision import EXACT
from repro_torch.serving import Request, ServingEngine


class Driver:
    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any],
                 device):
        from repro_torch.models.zamba2_published import (
            Zamba2Layout, Zamba2PublishedModel)

        self.config = config
        self.mix = traffic.mix(mix)
        self.device = torch.device(device)
        self.precision = config["dtype"]
        self.serving = config["serving"]
        self.lengths = list(self.serving["prompt_lengths"])
        if self.mix["pool"] % len(self.lengths):
            raise ValueError(f"a pool of {self.mix['pool']} does not hold "
                             f"each of {len(self.lengths)} lengths alike")
        if self.mix["batch"] > self.serving["max_batch"]:
            raise ValueError(f"a call of {self.mix['batch']} prompts is "
                             f"over the engine's batch "
                             f"{self.serving['max_batch']}")
        self.layout = Zamba2Layout.from_hf(config, name=config["name"])
        self.model = Zamba2PublishedModel(self.layout)
        self._work = {t: {"model": [counts_zamba2.prefill_call(
                              config, self.mix["batch"], t)],
                          "ssd": counts_zamba2.ssd_calls(
                              config, self.mix["batch"], t)}
                      for t in self.lengths}

    # ------------------------------------------------------------- inputs
    def prepare(self, seed: int) -> None:
        self.engine = self.params = self.weights = None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(traffic.subseed(seed, 10, 0))
        self.params = zamba2.init(self.config, gen)
        self.weights = _host_copy(self.params)
        self.engine = ServingEngine(
            self.layout, self.model, self.params,
            max_batch=self.serving["max_batch"],
            max_len=self.serving["max_len"], device=self.device)
        self.pool: List[np.ndarray] = []
        for slot in range(self.mix["pool"]):
            rng = np.random.default_rng(traffic.subseed(seed, 3, slot))
            self.pool.append(rng.integers(
                0, self.layout.vocab_size,
                (self.mix["batch"], self.length(slot))).astype(np.int32))
        per = max(1, self.mix["check_calls"] // len(self.lengths))
        self.kept = [Reservoir(per, traffic.subseed(seed, 4, k))
                     for k in range(len(self.lengths))]

    def length(self, i: int) -> int:
        return self.lengths[i % len(self.lengths)]

    def warmup(self) -> None:
        for i in range(len(self.lengths)):
            self.call(i, self.make(i), keep=False)

    # -------------------------------------------------------------- calls
    def make(self, i: int):
        prompts = self.pool[i % len(self.pool)]
        return [Request(rid=r, prompt=prompts[r],
                        max_new_tokens=self.serving["max_new_tokens"])
                for r in range(len(prompts))]

    def call(self, i: int, requests, keep: bool = True) -> Dict[str, Any]:
        self.engine.run(requests)
        if keep:
            self.kept[i % len(self.lengths)].offer(
                (i, self.engine.last_prefill_logits))
        return {"requests": len(requests),
                "counters": dict(self.model.last_prefill_counts)}

    def work(self, i: int):
        return self._work[self.length(i)]

    def release(self) -> None:
        """Frees the engine and the program's weights; the benchmark's own
        weights, the prompts and the held logits stay for the check."""
        self.engine = self.params = None

    # -------------------------------------------------------------- check
    def check(self, control: bool = False) -> Dict[str, float]:
        prec = zamba2.CONTROL if control else EXACT
        worst = 0.0
        held = sorted((item for r in self.kept for item in r.items),
                      key=lambda kv: kv[0])
        for i, logits in held:
            tokens = torch.from_numpy(self.pool[i % len(self.pool)]).to(
                self.device)
            ref = zamba2.logits(self.weights, self.config, tokens)[:, 0]
            got = (zamba2.logits(self.weights, self.config, tokens,
                                 prec=prec)[:, 0]
                   if control else logits.float())
            worst = max(worst, rel_err(got, ref))
        return {"logit_err": worst}


def _host_copy(weights: Any) -> Any:
    """A copy of a weight tree in host memory that shares no storage with
    it."""
    if isinstance(weights, dict):
        return {k: _host_copy(v) for k, v in weights.items()}
    if isinstance(weights, list):
        return [_host_copy(v) for v in weights]
    return weights.to("cpu", copy=True)
