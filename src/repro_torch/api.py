"""The execution half of the compile→run facade.

The JAX package compiles a network offline and ships the result as a
`repro.compiled_network` artifact:

    compiled = repro.compile("vgg16", repro.Target(device="moto2022"))
    compiled.save("vgg16.coexec.json")

The port loads that artifact, checks it, and runs it on a torch device:

    import repro_torch
    compiled = repro_torch.CompiledNetwork.load("vgg16.coexec.json")
    y = compiled.run()                   # on CUDA; device="cpu" for the CPU
    report = compiled.profile()          # per-node ExecutionReport
    y = compiled.run(fused=True)         # the segment walk: CUDA graphs

Loading checks the artifact's format, version and checksum (recomputed
exactly as the reference does), that the network fingerprint recomputed
from the plan's graph matches its provenance, and that every schedule
entry's kind matches its graph node.  Compiling, replanning and the static
verifier stay in the JAX package for now.

`Target` is the request half of a plan's provenance: `device` names the
simulated phone the plan was compiled for, not the torch device it runs
on, which every execution entry point takes as `device=`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Union

import torch

from repro_torch.runtime.plan import CoexecPlan, PlanProvenance

ARTIFACT_FORMAT = "repro.compiled_network"
ARTIFACT_VERSION = 1

#: Target.mesh policies
MESH_AUTO = "auto"               # split when 2 groups exist (always here)
MESH_SINGLE = "single"           # one group: every node runs exclusive
MESH_SPLIT = "split"             # require the 2-group split

#: the simulated devices and sync mechanisms plans are compiled for
DEVICES = ("moto2022", "oneplus11", "pixel4", "pixel5")
MECHANISMS = ("event", "svm_poll")


@dataclasses.dataclass(frozen=True)
class Target:
    """Where and how a network was compiled to run (the request half of
    provenance); validated eagerly, as in the reference."""

    device: str
    threads: int = 3
    mechanism: str = "svm_poll"
    step: int = 8
    seed: int = 1
    mesh: str = MESH_AUTO

    def __post_init__(self):
        if self.device not in DEVICES:
            raise ValueError(f"unknown device {self.device!r}; "
                             f"choices: {list(DEVICES)}")
        if self.mechanism not in MECHANISMS:
            raise ValueError(f"unknown sync mechanism {self.mechanism!r}; "
                             f"choices: {list(MECHANISMS)}")
        if type(self.threads) is not int or self.threads < 1:
            raise ValueError(f"threads must be a positive int, "
                             f"got {self.threads!r}")
        if type(self.step) is not int or self.step < 1:
            raise ValueError(f"step must be a positive int, "
                             f"got {self.step!r}")
        if self.mesh not in (MESH_AUTO, MESH_SINGLE, MESH_SPLIT):
            raise ValueError(f"unknown mesh policy {self.mesh!r}; "
                             f"choices: ['auto', 'single', 'split']")

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Target":
        return Target(**d)


def _artifact_checksum(doc: Dict[str, Any]) -> str:
    # the reference's digest, key for key
    body = {k: doc.get(k) for k in ("format", "version", "mode", "target",
                                    "plan")}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


class CompiledNetwork:
    """A loaded plan + its target, with lazily built executors (one per
    torch device).  `mode` is the planning mode the artifact records."""

    def __init__(self, plan: CoexecPlan, target: Target, *, mode: str):
        plan.check_graph()
        self.plan = plan
        self.target = target
        self.mode = mode
        self.last_report = None
        self._executors: Dict[str, Any] = {}

    @property
    def provenance(self) -> PlanProvenance:
        return self.plan.provenance

    @property
    def key(self) -> str:
        return self.plan.key

    @property
    def graph(self):
        return self.plan.graph_ir()

    def __repr__(self) -> str:
        return (f"CompiledNetwork(mode={self.mode!r}, "
                f"device={self.target.device!r}, key={self.key!r}, "
                f"units={len(self.plan.schedule)})")

    # --------------------------------------------------------- execution
    def executor(self, *, device: Union[str, torch.device, None] = None):
        """The (memoized) `PlanExecutor` of this plan on `device` (CUDA
        unless given; raises where CUDA is missing), with the reference's
        seed-0 weights."""
        from repro_torch.core.coexec import coexec_groups, resolve_device
        from repro_torch.runtime.executor import PlanExecutor

        dev = resolve_device(device)
        if str(dev) not in self._executors:
            n = 1 if self.target.mesh == MESH_SINGLE else 2
            self._executors[str(dev)] = PlanExecutor(
                self.plan, groups=coexec_groups(dev, n=n))
        return self._executors[str(dev)]

    def run(self, x=None, *, device: Union[str, torch.device, None] = None,
            chain: bool = True, warmup: bool = False,
            fused: bool = False) -> torch.Tensor:
        """Execute the plan once; returns the output activation.

        `fused=True` takes the segment walk (one CUDA graph per fused
        segment on the card, bit-identical outputs); the per-node walk is
        the `fused=False` reference.  The run's `ExecutionReport` is kept
        on `last_report` (`profile()` is the report-first spelling)."""
        y, self.last_report = self.executor(device=device).run(
            x, chain=chain, warmup=warmup, fused=fused)
        return y

    def profile(self, x=None, *,
                device: Union[str, torch.device, None] = None,
                chain: bool = True, warmup: bool = True,
                fused: bool = False):
        """Execute the plan and return its executed-vs-predicted
        `ExecutionReport` (warmed up by default, so timings are steady
        state, not kernel builds and graph captures)."""
        _, self.last_report = self.executor(device=device).run(
            x, chain=chain, warmup=warmup, fused=fused)
        return self.last_report

    # ------------------------------------------------------------- codecs
    def to_json(self) -> Dict[str, Any]:
        doc = {"format": ARTIFACT_FORMAT, "version": ARTIFACT_VERSION,
               "mode": self.mode, "target": self.target.to_json(),
               "plan": self.plan.to_json()}
        doc["checksum"] = _artifact_checksum(doc)
        return doc

    @staticmethod
    def from_json(doc: Dict[str, Any]) -> "CompiledNetwork":
        if doc.get("format") != ARTIFACT_FORMAT:
            raise ValueError(f"not a {ARTIFACT_FORMAT} artifact "
                             f"(format={doc.get('format')!r})")
        if doc.get("version") != ARTIFACT_VERSION:
            raise ValueError(f"unsupported artifact version "
                             f"{doc.get('version')!r}")
        if doc.get("checksum") != _artifact_checksum(doc):
            raise ValueError("artifact checksum mismatch: the file was "
                             "modified after it was saved")
        return CompiledNetwork(plan=CoexecPlan.from_json(doc["plan"]),
                               target=Target.from_json(doc["target"]),
                               mode=doc["mode"])

    @staticmethod
    def load(path: Union[str, Path]) -> "CompiledNetwork":
        return CompiledNetwork.from_json(json.loads(Path(path).read_text()))
