"""A compiled co-execution plan, called one request at a time.

The system under test is `repro_torch.CompiledNetwork.load(<frozen
artifact>).executor(device, dtype)` and `PlanExecutor.run(x, fused=True)`:
the fused segment walk, one CUDA graph per fused segment, its last sync
before it returns.  The benchmark draws the weights (one seeded buffer on
the device) and a pool of input activations from the seed, hands the
weights to `load_params`, and keeps its own tensors for the reference.

The check holds a reservoir sample, drawn from the seed, of the outputs
the window's requests produced, and compares each with the plain graph
run on the same input (`reference/plan_graph.py`): `out_err` is the
largest |output - reference| over the reference's largest |value|, worst
request first.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import counts, traffic
from portbench.compare import rel_err
from portbench.reference import plan_graph
from portbench.reference.precision import CONTROLS, EXACT, no_tf32


class Reservoir:
    """A uniform sample of k of the items offered, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(traffic.subseed(seed, 4))
        self.items: List[Any] = []
        self.seen = 0

    def offer(self, item: Any) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


class Driver:
    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any],
                 device):
        import repro_torch

        self.config = config
        self.mix = traffic.mix(mix)
        self.device = torch.device(device)
        self.precision = config["dtype"]
        path = Path(config["dir"]) / config["artifact"]
        self.artifact = json.loads(path.read_text())
        self.nodes = counts.plan_nodes(self.artifact)
        compiled = repro_torch.CompiledNetwork.load(path)
        self.exe = compiled.executor(device=self.device,
                                     dtype=config["dtype"])
        self.order = [spec.node_id for spec in self.exe.specs]
        if sorted(self.order) != sorted(n["id"] for n in self.nodes):
            raise ValueError("the executor's nodes are not the artifact's")
        self.input_shape = plan_graph.input_shape(self.nodes[0])
        if self.mix["batch"] != 1:
            raise ValueError(f"a plan takes one request a call; the mix "
                             f"asks for {self.mix['batch']}")
        self._work = counts.plan_request(self.artifact)

    # ------------------------------------------------------------- inputs
    def prepare(self, seed: int) -> None:
        by_id = {n["id"]: n for n in self.nodes}
        shaped = [by_id[i] for i in self.order if "op" in by_id[i]]
        total = sum(math.prod(plan_graph.weight_shape(n)) for n in shaped)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(traffic.subseed(seed, 10, 0))
        buf = torch.empty(total, dtype=torch.float32, device=self.device)
        buf.normal_(generator=gen)
        self.weights: Dict[str, torch.Tensor] = {}
        off = 0
        for node in shaped:
            shape = plan_graph.weight_shape(node)
            w = buf[off:off + math.prod(shape)].view(shape)
            off += math.prod(shape)
            w.mul_(1.0 / math.sqrt(plan_graph.fan_in(node)))
            self.weights[node["id"]] = w
        self.exe.load_params([self.weights[i].cpu().numpy()
                              if i in self.weights else None
                              for i in self.order])
        gen.manual_seed(traffic.subseed(seed, 3, 0))
        self.pool = torch.randn((self.mix["pool"],) + self.input_shape,
                                generator=gen, device=self.device,
                                dtype=torch.float32)
        self.kept = Reservoir(self.mix["check_calls"], seed)

    def warmup(self) -> None:
        for i in range(2):
            self.call(i, self.make(i), keep=False)

    # -------------------------------------------------------------- calls
    def make(self, i: int) -> torch.Tensor:
        return self.pool[i % len(self.pool)]

    def call(self, i: int, x: torch.Tensor, keep: bool = True
             ) -> Dict[str, Any]:
        y, report = self.exe.run(x, fused=True)
        if keep:
            self.kept.offer((i, y))
        return {"requests": 1,
                "counters": {"walk_syncs": report.sync_points}}

    def work(self, i: int) -> Dict[str, List[counts.Work]]:
        return self._work

    def release(self) -> None:
        self.exe = None

    # -------------------------------------------------------------- check
    def check(self, control: bool = False) -> Dict[str, float]:
        prec = CONTROLS[self.precision] if control else EXACT
        worst = 0.0
        refs: Dict[int, torch.Tensor] = {}
        with no_tf32():
            for i, y in sorted(self.kept.items, key=lambda kv: kv[0]):
                slot = i % len(self.pool)
                if slot not in refs:
                    refs[slot] = plan_graph.run(self.nodes, self.weights,
                                                self.pool[slot])
                ref = refs[slot]
                got = (plan_graph.run(self.nodes, self.weights,
                                      self.pool[slot], prec)
                       if control else y.float())
                worst = max(worst, rel_err(got, ref))
        return {"out_err": worst}
