"""The execution half of the compile→run facade.

The JAX package compiles a network offline and ships the result as a
`repro.compiled_network` artifact:

    compiled = repro.compile("vgg16", repro.Target(device="moto2022"))
    compiled.save("vgg16.coexec.json")

The port loads that artifact, verifies it, and runs it on a torch device:

    import repro_torch
    compiled = repro_torch.CompiledNetwork.load("vgg16.coexec.json")
    y = compiled.run()                   # on CUDA; device="cpu" for the CPU
    y = compiled.run(dtype="bfloat16")   # bf16 parameters and activations
    report = compiled.profile()          # per-node ExecutionReport
    y = compiled.run(fused=True)         # the segment walk: CUDA graphs
    print(compiled.explain())            # the per-node decision table

Loading is strict, as in the reference: the artifact's format, version and
checksum (recomputed exactly as the reference does; rules
`artifact.format`, `artifact.checksum`) and then the whole plan go through
the port's static verifier (`repro_torch.analysis`), which raises
`VerificationError` with the reference's rule ids on any error.
`verify=False` skips the plan's verification (the artifact checks stay).
Compiling and replanning stay in the JAX package for now.

`Target` is the request half of a plan's provenance: `device` names the
simulated phone the plan was compiled for, not the torch device it runs
on, which every execution entry point takes as `device=`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import torch

from repro_torch.core.networks import Unit
from repro_torch.runtime.plan import (CoexecPlan, PartitionDecision,
                                      PlanProvenance, spec_label)

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
    torch device, dtype and weight seed).  `mode` is the planning mode the
    artifact records."""

    def __init__(self, plan: CoexecPlan, target: Target, *, mode: str):
        self.plan = plan
        self.target = target
        self.mode = mode
        self.last_report = None
        self._executors: Dict[Tuple[str, str, int], Any] = {}

    @property
    def provenance(self) -> PlanProvenance:
        return self.plan.provenance

    @property
    def key(self) -> str:
        return self.plan.key

    @property
    def units(self) -> List[Unit]:
        """Legacy unit-list view (chain plans only; raises for DAG plans
        — use `.graph` instead)."""
        return self.plan.units

    @property
    def graph(self):
        return self.plan.graph_ir()

    @property
    def decisions(self) -> List[PartitionDecision]:
        return self.plan.decisions

    @property
    def decisions_by_node(self) -> Dict[str, PartitionDecision]:
        return self.plan.decisions_by_node

    def report(self):
        """The planning-time `PlanReport` (None for plans that record no
        end-to-end latency)."""
        return self.plan.report()

    def __repr__(self) -> str:
        return (f"CompiledNetwork(mode={self.mode!r}, "
                f"device={self.target.device!r}, key={self.key!r}, "
                f"units={len(self.plan.schedule)})")

    # --------------------------------------------------------- execution
    def executor(self, *, device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype] = "float32", seed: int = 0):
        """The `PlanExecutor` of this plan on `device` (CUDA unless given;
        raises where CUDA is missing) in `dtype` (float32 or bfloat16),
        with the reference's weights for `seed`; memoized per (device,
        dtype, seed)."""
        from repro_torch.core.coexec import coexec_groups, resolve_device
        from repro_torch.runtime.executor import PlanExecutor, resolve_dtype

        dev = resolve_device(device)
        dt = resolve_dtype(dtype)
        key = (str(dev), str(dt), seed)
        if key not in self._executors:
            n = 1 if self.target.mesh == MESH_SINGLE else 2
            self._executors[key] = PlanExecutor(
                self.plan, groups=coexec_groups(dev, n=n), seed=seed,
                dtype=dt)
        return self._executors[key]

    def run(self, x=None, *, device: Union[str, torch.device, None] = None,
            dtype: Union[str, torch.dtype] = "float32", seed: int = 0,
            chain: bool = True, warmup: bool = False,
            fused: bool = False) -> torch.Tensor:
        """Execute the plan once; returns the output activation.

        `fused=True` takes the segment walk (one CUDA graph per fused
        segment on the card, bit-identical outputs); the per-node walk is
        the `fused=False` reference.  The run's `ExecutionReport` is kept
        on `last_report` (`profile()` is the report-first spelling)."""
        exe = self.executor(device=device, dtype=dtype, seed=seed)
        y, self.last_report = exe.run(x, chain=chain, warmup=warmup,
                                      fused=fused)
        return y

    def profile(self, x=None, *,
                device: Union[str, torch.device, None] = None,
                dtype: Union[str, torch.dtype] = "float32", seed: int = 0,
                chain: bool = True, warmup: bool = True,
                fused: bool = False):
        """Execute the plan and return its executed-vs-predicted
        `ExecutionReport` (warmed up by default, so timings are steady
        state, not kernel builds and graph captures)."""
        exe = self.executor(device=device, dtype=dtype, seed=seed)
        _, self.last_report = exe.run(x, chain=chain, warmup=warmup,
                                      fused=fused)
        return self.last_report

    # ------------------------------------------------------------ explain
    def explain(self) -> str:
        """Per-op decision table: what the planner chose and what it
        predicted (plan introspection, no execution), in the reference's
        format, ending in the static verifier's verdict."""
        from repro_torch.analysis import errors as diag_errors, verify_plan
        from repro_torch.kernels.registry import axis_spec

        prov = self.provenance
        tune_tag = f" tune={prov.tune}" if prov.tune else ""
        lines = [
            f"CompiledNetwork [{self.mode}] device={prov.device} "
            f"cpu{prov.threads} mechanism={prov.mechanism} "
            f"step={prov.step} planner={prov.planner}{tune_tag}",
            f"  key={self.key}  fingerprint={prov.network_fingerprint}",
            f"  {'node':>12}  {'seg':>3}  {'label':<42} "
            f"{'cpu':>5}/{'gpu':<5} {'pred_us':>9}  placement",
        ]
        n_co = 0
        for spec in self.plan.exec_specs():
            label = spec_label(spec)     # same renderer as execute --per-op
            tag = spec.node_id
            seg = f"{spec.segment}" if spec.segment >= 0 else "-"
            if spec.unit in ("pool", "add"):
                lines.append(f"  {tag:>12}  {seg:>3}  {label:<42} "
                             f"{'-':>5}/{'-':<5} {'-':>9}  gpu (no sync)")
                continue
            c_cpu, c_gpu = spec.c_slow, spec.c_fast
            mode_tag = ""
            if spec.unit in ("attention", "ssm") and spec.op is not None \
                    and getattr(spec.op, "mode", ""):
                mode_tag = f", mode={spec.op.mode}"
            if spec.coexec:
                n_co += 1
                if spec.axis != "channel":
                    size = axis_spec(spec.unit, spec.axis).size(spec.op)
                    placement = (f"coexec {spec.axis}-split "
                                 f"{c_gpu}/{size}{mode_tag}")
                else:
                    placement = "co-executed"
            elif spec.unit in ("attention", "ssm"):
                if c_gpu == 0 and c_cpu == 0:
                    placement = "gpu-only (unsplit kind)"   # legacy plan
                elif c_gpu:
                    placement = f"gpu-only{mode_tag}"
                else:
                    placement = f"cpu-only{mode_tag}"
            elif c_gpu:
                placement = "gpu-only"
            else:
                placement = "cpu-only"
            lines.append(f"  {tag:>12}  {seg:>3}  {label:<42} {c_cpu:>5}/"
                         f"{c_gpu:<5} {spec.pred_total_us:>9.1f}  "
                         f"{placement}")
        n_ops = sum(1 for e in self.plan.schedule
                    if e["unit"] not in ("pool", "add"))
        parts = self.plan.segment_partition()
        n_fused = sum(1 for s in parts if s.kind == "fused")
        tail = (f"  {n_co}/{n_ops} ops co-executed | "
                f"{len(parts)} segments ({n_fused} fused)")
        if self.plan.end_to_end_us is not None:
            speedup = self.plan.baseline_us / self.plan.end_to_end_us
            tail += (f" | baseline {self.plan.baseline_us / 1e3:.1f} ms -> "
                     f"end-to-end {self.plan.end_to_end_us / 1e3:.1f} ms "
                     f"({speedup:.2f}x)")
        lines.append(tail)
        diags = verify_plan(self.plan, stats=False)
        errs = diag_errors(diags)
        if errs:
            lines.append(f"  verify: {len(errs)} error(s) — {errs[0]}")
        else:
            warns = sum(1 for d in diags if d.severity == "warning")
            lines.append("  verify: clean"
                         + (f" ({warns} warnings)" if warns else ""))
        return "\n".join(lines)

    # ------------------------------------------------------------- codecs
    def to_json(self) -> Dict[str, Any]:
        doc = {"format": ARTIFACT_FORMAT, "version": ARTIFACT_VERSION,
               "mode": self.mode, "target": self.target.to_json(),
               "plan": self.plan.to_json()}
        doc["checksum"] = _artifact_checksum(doc)
        return doc

    @staticmethod
    def from_json(doc: Dict[str, Any], *,
                  verify: bool = True) -> "CompiledNetwork":
        """Decode an artifact document.  Its format, version and checksum
        are always checked; ``verify=True`` (default) also statically
        verifies the embedded plan.  Raises `VerificationError` (a
        ValueError) with the reference's rule ids on any error."""
        from repro_torch.analysis import raise_on_error, verify_artifact
        raise_on_error(verify_artifact(doc, stats=False, plan=verify),
                       "artifact")
        return CompiledNetwork(plan=CoexecPlan.from_json(doc["plan"],
                                                         verify=False),
                               target=Target.from_json(doc["target"]),
                               mode=doc["mode"])

    def save(self, path: Union[str, Path]) -> Path:
        """Write the shippable artifact (target + plan + checksum) as JSON,
        byte for byte as the reference writes it; `load` round-trips it."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1))
        return path

    @staticmethod
    def load(path: Union[str, Path], *,
             verify: bool = True) -> "CompiledNetwork":
        """Load a saved artifact (see `from_json`; ``verify=False`` to
        inspect a quarantined artifact anyway)."""
        return CompiledNetwork.from_json(json.loads(Path(path).read_text()),
                                         verify=verify)
