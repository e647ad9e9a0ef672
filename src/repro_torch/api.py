"""The compile→run facade of the port.

Compile a network into a co-execution plan and run it on a torch device,
with no JAX anywhere:

    import repro_torch
    target = repro_torch.Target(device="moto2022", threads=3)
    compiled = repro_torch.compile("vgg16", target)     # cached planning
    y = compiled.run()                   # on CUDA; device="cpu" for the CPU
    y = compiled.run(dtype="bfloat16")   # bf16 parameters and activations
    report = compiled.profile()          # per-node ExecutionReport
    y = compiled.run(fused=True)         # the segment walk: CUDA graphs
    print(compiled.explain())            # the per-node decision table
    compiled.save("vgg16.coexec.json")   # the shippable artifact
    tuned = repro_torch.compile("vgg16", target, tune=True)  # on the card
    compiled.record(); compiled.record() # walls into the measurement store
    replanned, diff = compiled.replan()  # calibrated predictors, new plan
    pf = repro_torch.compile_portfolio("zamba2-7b", target, blocks=9)

`compile` is the port's copy of `repro.compile`: it resolves the network
(a `Graph`, a registered network or model name, a unit list, or a bare op
list), trains or loads the GBDT predictors on the simulated phone the
`Target` names, and runs the cached planners (`runtime/cache.py`).  The
planning half is host numpy with the reference's float operations in the
reference's order, so the plan, its key, its predictor checksum and the
saved artifact are the reference's byte for byte, and the two packages
share one on-disk plan cache.  Predictor caches are the port's own
(pickles of the port's classes, `port_mux_*` files).

`compile(tune=True)` times the Hopper kernels' launch candidates on the
card (`runtime/autotune.py`) and runs the plan with the winners; the plan
document differs from the untuned one only in its provenance `tune` tag
(the port's own, `hopper-tune-v1.k2`), and `save` writes the launches
beside the artifact, as `<stem>.hopper_tiles.json`.

`record()` / `recalibrate()` / `replan()` close the measurement loop
(`repro_torch.measure`), and `compile_portfolio` compiles one plan per
(batch, seq) serving bucket (`PlanPortfolio`); both give the reference's
documents byte for byte for the same inputs.

`CompiledNetwork.load` reads an artifact either package saved.  Loading is
strict, as in the reference: the artifact's format, version and checksum
(recomputed exactly as the reference does; rules `artifact.format`,
`artifact.checksum`) and then the whole plan go through the port's static
verifier (`repro_torch.analysis`), which raises `VerificationError` with
the reference's rule ids on any error.  `verify=False` skips the plan's
verification (the artifact checks stay).  An artifact tuned by the port
loads with its sidecar of launches, verified entry by entry, and raises
without it; one the reference tuned (TPU `tile` keys, tag `tune-v1.k1`)
loads and runs with the default Hopper launches: no Hopper kernel reads a
TPU tile.

`Target` is the request half of a plan's provenance: `device` names the
simulated phone the plan is compiled for, not the torch device it runs
on, which every execution entry point takes as `device=`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.networks import NETWORKS, Unit
from repro_torch.core.simulator.devices import DEVICES
from repro_torch.core.sync import SyncMechanism
from repro_torch.core.types import ConvOp, LinearOp, Op
from repro_torch.graph.ir import Graph, from_units
from repro_torch.runtime.cache import (PlanCache, grid_plan_graph_cached,
                                       partition_ops_plan_cached,
                                       plan_graph_cached)
from repro_torch.kernels.registry import op_label
from repro_torch.runtime.plan import (CoexecPlan, PartitionDecision,
                                      PlanProvenance, spec_label)

#: compile() planning modes
MODE_PREDICTED = "predicted"     # GBDT predictors (the deployable path)
MODE_GRID = "grid"               # measurement-driven oracle (upper bound)

ARTIFACT_FORMAT = "repro.compiled_network"
ARTIFACT_VERSION = 1

DEFAULT_CACHE_DIR = "reports/plans"
DEFAULT_MEASUREMENTS_DIR = "reports/measurements"

#: Target.mesh policies
MESH_AUTO = "auto"               # split when 2 groups exist (always here)
MESH_SINGLE = "single"           # one group: every node runs exclusive
MESH_SPLIT = "split"             # require the 2-group split


@dataclasses.dataclass(frozen=True)
class Target:
    """Where and how a network is compiled to run (the request half of
    provenance); validated eagerly, as in the reference.  `mechanism`
    takes a `SyncMechanism` or its string value and keeps the string."""

    device: str
    threads: int = 3
    mechanism: str = SyncMechanism.SVM_POLL.value
    step: int = 8
    seed: int = 1
    mesh: str = MESH_AUTO

    def __post_init__(self):
        if self.device not in DEVICES:
            raise ValueError(f"unknown device {self.device!r}; "
                             f"choices: {sorted(DEVICES)}")
        if isinstance(self.mechanism, SyncMechanism):
            object.__setattr__(self, "mechanism", self.mechanism.value)
        try:
            SyncMechanism(self.mechanism)
        except ValueError:
            raise ValueError(
                f"unknown sync mechanism {self.mechanism!r}; "
                f"choices: {[m.value for m in SyncMechanism]}") from None
        # exact int checks: threads=True would serialize as JSON `true`
        # and split the cache key from threads=1
        if type(self.threads) is not int or self.threads < 1:
            raise ValueError(f"threads must be a positive int, "
                             f"got {self.threads!r}")
        if type(self.step) is not int or self.step < 1:
            raise ValueError(f"step must be a positive int, "
                             f"got {self.step!r}")
        if self.mesh not in (MESH_AUTO, MESH_SINGLE, MESH_SPLIT):
            raise ValueError(f"unknown mesh policy {self.mesh!r}; "
                             f"choices: ['auto', 'single', 'split']")

    @property
    def sync_mechanism(self) -> SyncMechanism:
        return SyncMechanism(self.mechanism)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Target":
        return Target(**d)


# -------------------------------------------------------------- predictors

def _trained_mux_predictors(device: str, threads: int, *, samples: int,
                            estimators: int,
                            cache_dir: Optional[Union[str, Path]] = None,
                            kinds: Sequence[str] = ("linear", "conv")):
    """Train (or load from `cache_dir`) the (cpu, gpu) MuxPredictor pair.

    The on-disk layout is the reference's, one pickle per underlying
    LatencyPredictor keyed by every training knob, under a stem of the
    port's own (`port_mux_...`): the files hold the port's classes, and
    the reference's `mux_...` pickles are never opened.  A load is
    checksum-identical to a retrain; a file that fails to load (corrupt,
    or naming any global but the predictor classes and numpy's array
    reconstructors, see `train._PortUnpickler`) means a retrain.
    """
    from repro_torch.runtime.plan import train_mux_predictors

    if cache_dir is None:
        return train_mux_predictors(device, threads, samples=samples,
                                    estimators=estimators, kinds=kinds)

    from repro_torch.core.predictor.train import (LatencyPredictor,
                                                  MuxPredictor)
    root = Path(cache_dir)
    stem = f"port_mux_{device}_cpu{threads}_{samples}x{estimators}"
    paths = {f"{side}_{kind}": root / f"{stem}_{side}_{kind}.pkl"
             for side in ("cpu", "gpu") for kind in kinds}
    if all(p.exists() for p in paths.values()):
        try:
            def member(side, kind):
                if kind not in kinds:
                    return None
                return LatencyPredictor.load(paths[f"{side}_{kind}"])

            cp = MuxPredictor(member("cpu", "linear"),
                              member("cpu", "conv"),
                              attention=member("cpu", "attention"),
                              ssm=member("cpu", "ssm"))
            gp = MuxPredictor(member("gpu", "linear"),
                              member("gpu", "conv"),
                              attention=member("gpu", "attention"),
                              ssm=member("gpu", "ssm"))
            return cp, gp
        except Exception:           # noqa: BLE001 — bad cache: retrain
            pass
    cp, gp = train_mux_predictors(device, threads, samples=samples,
                                  estimators=estimators, kinds=kinds)
    root.mkdir(parents=True, exist_ok=True)
    for side, p in (("cpu", cp), ("gpu", gp)):
        for kind in kinds:
            m = p.member(kind)
            if m is not None:
                m.save(paths[f"{side}_{kind}"])
    return cp, gp


# ------------------------------------------------------- network resolution

def available_networks() -> Dict[str, List[str]]:
    """Every name `compile` resolves, from the two registries: legacy
    unit-chain networks (`core.networks.NETWORKS`) and decoder-block model
    graphs (`graph.frontends`: tiny configs + `models.registry`)."""
    from repro_torch.graph.frontends import model_names
    return {"networks": sorted(NETWORKS), "models": model_names()}


def _unknown_name_error(name: str) -> ValueError:
    names = available_networks()
    return ValueError(
        f"unknown network {name!r}; registered unit networks: "
        f"{names['networks']}; model graphs (via graph.from_model): "
        f"{names['models']}")


def _resolve_graph(network) -> Tuple[Union[Graph, List[Op]], bool]:
    """Normalize `compile`'s first argument to (graph_or_ops, is_graph).

    Accepts a `Graph`, a registered network or model name, a unit list
    (("conv"/"linear"/"pool", payload) tuples), or a bare op list.
    Everything except bare op lists lowers to a Graph; bare op lists are
    planned per op (no end-to-end report, threads/seed-free provenance),
    hence the flag.
    """
    if isinstance(network, Graph):
        return network, True
    if isinstance(network, str):
        if network in NETWORKS:
            return from_units(NETWORKS[network]()), True
        from repro_torch.graph.frontends import from_model, model_names
        if network in model_names():
            return from_model(network), True
        raise _unknown_name_error(network)
    seq = list(network)
    if not seq:
        raise ValueError("cannot compile an empty network")
    if all(isinstance(e, (LinearOp, ConvOp)) for e in seq):
        return seq, False
    if all(isinstance(e, tuple) and len(e) == 2 and isinstance(e[0], str)
           for e in seq):
        return from_units(seq), True
    raise TypeError(
        "network must be a repro_torch.graph.Graph, a registered name, a "
        "unit list [(kind, payload), ...], or a bare op list "
        f"[LinearOp/ConvOp, ...]; got {type(seq[0]).__name__} elements")


# ------------------------------------------------------------------ compile

def compile(network, target: Target, *,               # noqa: A001 — facade
            mode: str = MODE_PREDICTED,
            cache: Union[PlanCache, str, Path] = DEFAULT_CACHE_DIR,
            predictors=None,
            samples: int = 400, estimators: int = 60,
            predictor_cache: Optional[Union[str, Path]] = None,
            bucket: str = "",
            tune: bool = False,
            tune_cache=None) -> "CompiledNetwork":
    """Compile a network into a `CompiledNetwork` (cached planning), as
    `repro.compile` does.

    * `network` — a `Graph`, a registered name ("resnet18",
      "tiny_decoder", "zamba2-7b", ...), a unit list, or a bare op list.
    * `target` — the validated `Target` (device/threads/mechanism/step/
      seed/mesh).
    * `mode` — "predicted" plans with trained GBDT predictors (the paper's
      deployable path); "grid" uses the measurement-driven oracle and
      needs no predictors.
    * `cache` — a `PlanCache` or a directory path; planning is skipped
      entirely on a warm hit (the plan file is just read back).  The
      cache's files are the reference's: a plan either package wrote
      warm-hits in the other.
    * `predictors` — optional pre-trained (cpu, gpu) pair; when omitted in
      "predicted" mode a deterministic pair is trained (or loaded from
      `predictor_cache`) with `samples`/`estimators`.
    * `bucket` — a serving (batch, seq) bucket tag folded into the
      provenance digest; only graph plans in "predicted" mode take it.

    `tune=True` runs the Hopper launch autotuner (`runtime.autotune`)
    over the plan's unique ops, on the card (a host without CUDA raises
    before anything is planned), and the compiled network runs each node
    with its op's winning launch.  The tune-cache version folds into
    provenance, so tuned and untuned plans occupy distinct cache entries,
    and the tuned document is the untuned one with that tag: no decision
    carries a Hopper value.  `tune_cache` is a `TuneCache` or a directory
    (default `reports/tune`); through a warm tune cache the tune pass
    measures nothing.
    """
    if not isinstance(target, Target):
        raise TypeError(f"target must be a repro_torch.Target, "
                        f"got {type(target).__name__}")
    if mode not in (MODE_PREDICTED, MODE_GRID):
        raise ValueError(f"unknown mode {mode!r}; "
                         f"choices: ['predicted', 'grid']")
    graph_or_ops, is_graph = _resolve_graph(network)
    if bucket and (mode != MODE_PREDICTED or not is_graph):
        raise ValueError("bucket= requires a graph network in "
                         "mode='predicted' (portfolio entries must be "
                         "replannable)")

    tune_tag = ""
    annotate = None
    tuned: Optional[List[Dict[str, Any]]] = None
    if tune:
        from repro_torch.runtime.autotune import (DEFAULT_TUNE_DIR,
                                                  TuneCache,
                                                  annotate_plan_tiles,
                                                  measure_device,
                                                  tune_cache_version)
        # the card first: without CUDA nothing is planned or written
        kind, backend = measure_device()
        tc = tune_cache
        if not isinstance(tc, TuneCache):
            tc = TuneCache(Path(tc) if tc is not None
                           else Path(DEFAULT_TUNE_DIR))
        tune_tag = tune_cache_version()

        def tune_pass(plan):
            return annotate_plan_tiles(plan, cache=tc, device=kind,
                                       backend=backend)

        def annotate(plan):
            nonlocal tuned
            tuned = tune_pass(plan)
            return plan

    if not isinstance(cache, PlanCache):
        cache = PlanCache(Path(cache))
    mech = target.sync_mechanism
    hits_before = cache.hits

    if mode == MODE_GRID:
        if predictors is not None:
            raise ValueError("mode='grid' is measurement-driven and takes "
                             "no predictors; drop predictors= or use "
                             "mode='predicted'")
        if not is_graph:
            from repro_torch.kernels.registry import op_kind
            graph_or_ops = from_units(
                [(op_kind(op), op) for op in graph_or_ops])
        plan = grid_plan_graph_cached(
            graph_or_ops, target.device, target.threads, mechanism=mech,
            step=target.step, seed=target.seed, tune=tune_tag,
            annotate=annotate, cache=cache)
    else:
        if predictors is None:
            kinds: Tuple[str, ...] = ("linear", "conv")
            if is_graph:
                # decode kinds present in the graph get predictor members
                # so the planner can price their (axis, split, mode)
                # candidates; conv/linear-only graphs keep the plain pair
                # (and its checksum)
                kinds += tuple(sorted(
                    {n.kind for n in graph_or_ops
                     if n.op is not None and n.kind in ("attention", "ssm")}))
            predictors = _trained_mux_predictors(
                target.device, target.threads, samples=samples,
                estimators=estimators, cache_dir=predictor_cache,
                kinds=kinds)
        cpu_pred, gpu_pred = predictors
        if gpu_pred.device != target.device:
            raise ValueError(
                f"predictors were trained for {gpu_pred.device!r} but the "
                f"target device is {target.device!r}")
        if is_graph:
            plan = plan_graph_cached(
                graph_or_ops, cpu_pred, gpu_pred, threads=target.threads,
                mechanism=mech, step=target.step, seed=target.seed,
                bucket=bucket, tune=tune_tag, annotate=annotate,
                cache=cache)
        else:
            plan = partition_ops_plan_cached(
                graph_or_ops, cpu_pred, gpu_pred,
                mechanism=mech, step=target.step, tune=tune_tag,
                annotate=annotate, cache=cache)
    if tune and tuned is None:        # a warm plan hit: the tune cache's
        tuned = tune_pass(plan)

    return CompiledNetwork(plan=plan, target=target, mode=mode,
                           from_cache=cache.hits > hits_before,
                           predictors=predictors, tuned=tuned)


# --------------------------------------------------------- compiled network

def _artifact_checksum(doc: Dict[str, Any]) -> str:
    # the reference's digest, key for key
    body = {k: doc.get(k) for k in ("format", "version", "mode", "target",
                                    "plan")}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


class CompiledNetwork:
    """A compiled or loaded plan + its target, with lazily built executors
    (one per torch device, dtype and weight seed).  `mode` is the planning
    mode; `from_cache` says whether `compile` read the plan back from the
    plan cache; `predictors` is the (cpu, gpu) pair it planned with (None
    for grid plans and loaded artifacts); `calibration` is the
    `Calibrator` of the last `recalibrate()` (or the one a `replan()`
    planned with); `tuned` is a tuned compile's tune entries, one per
    unique op (None for an untuned plan), whose launches its executors
    run."""

    def __init__(self, plan: CoexecPlan, target: Target, *,
                 mode: str = MODE_PREDICTED, from_cache: bool = False,
                 predictors=None,
                 tuned: Optional[List[Dict[str, Any]]] = None):
        from repro_torch.runtime.autotune import (launches_from_entries,
                                                  tune_cache_version)
        if plan.provenance.tune == tune_cache_version() and tuned is None:
            raise ValueError(
                f"plan {plan.key} was tuned for the port's Hopper kernels "
                f"({plan.provenance.tune}) and needs its tune entries "
                f"(an artifact's sidecar); compile it again with tune=True")
        self.plan = plan
        self.target = target
        self.mode = mode
        self.from_cache = from_cache
        self.predictors = predictors
        self.tuned = tuned
        #: op -> its tuned Hopper launch (empty: every kernel's planner)
        self.launches = launches_from_entries(tuned or [])
        self.last_report = None
        self.calibration = None
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
                dtype=dt, launches=self.launches)
        return self._executors[key]

    def run(self, x=None, *, device: Union[str, torch.device, None] = None,
            dtype: Union[str, torch.dtype] = "float32", seed: int = 0,
            chain: bool = True, warmup: bool = False,
            fused: bool = False) -> torch.Tensor:
        """Execute the plan once; returns the output activation.

        `fused=True` takes the segment walk (one CUDA graph per captured
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

    # ------------------------------------- measurement & adaptive replan
    def _store(self, store):
        from repro_torch.measure.store import MeasurementStore
        if isinstance(store, MeasurementStore):
            return store
        return MeasurementStore(Path(store))

    def record(self, x=None, *, store=DEFAULT_MEASUREMENTS_DIR,
               device: Union[str, torch.device, None] = None,
               dtype: Union[str, torch.dtype] = "float32", seed: int = 0,
               chain: bool = True, warmup: bool = True,
               fused: bool = False):
        """Execute the plan (`profile`, on CUDA unless `device` says
        otherwise) and append its per-node `MeasurementRecord`s to the
        measurement store, keyed by this plan's provenance digest.

        Returns the `ExecutionReport`; the accumulated records are what
        `recalibrate()` fits on.  Fused runs record with `source="fused"`
        (segment wall attributed pro rata) and feed the same fit."""
        report = self.profile(x, device=device, dtype=dtype, seed=seed,
                              chain=chain, warmup=warmup, fused=fused)
        self._store(store).append(report)
        return report

    def recalibrate(self, store=DEFAULT_MEASUREMENTS_DIR):
        """Fit a `Calibrator` from every execution recorded for this plan
        and keep it on `self.calibration` (replan() uses it).

        Raises ValueError when nothing was recorded yet: call `record()`
        (ideally >= 2 runs) first."""
        from repro_torch.measure.calibrate import Calibrator
        records = self._store(store).load(self.key)
        if not records:
            raise ValueError(
                f"no recorded executions for plan {self.key}; call "
                f"record() first (>= 2 runs give a stable fit)")
        self.calibration = Calibrator.fit(records)
        return self.calibration

    def replan(self, calibrator=None, *, store=DEFAULT_MEASUREMENTS_DIR,
               cache: Union[PlanCache, str, Path] = DEFAULT_CACHE_DIR):
        """Re-plan with calibrated predictors; returns (new
        CompiledNetwork, PlanDiff).

        Uses `calibrator`, falling back to `self.calibration`, falling back
        to `recalibrate(store)`.  The new plan lands in the plan cache
        under a new provenance digest (calibration version folded in); the
        old entry is untouched."""
        if self.mode != MODE_PREDICTED or self.predictors is None:
            raise ValueError(
                "replan() needs the (cpu, gpu) predictors of a "
                "mode='predicted' compile; grid plans are "
                "measurement-driven and artifacts carry no predictors")
        cal = calibrator or self.calibration or self.recalibrate(store)
        if not isinstance(cache, PlanCache):
            cache = PlanCache(Path(cache))
        from repro_torch.measure.replan import replan as _replan
        cpu_pred, gpu_pred = self.predictors
        hits_before = cache.hits
        new_plan, diff = _replan(self.plan, cpu_pred, gpu_pred, cal,
                                 cache=cache)
        compiled = CompiledNetwork(plan=new_plan, target=self.target,
                                   mode=self.mode,
                                   from_cache=cache.hits > hits_before,
                                   predictors=self.predictors)
        compiled.calibration = cal
        return compiled, diff

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
    def from_json(doc: Dict[str, Any], *, verify: bool = True,
                  tuned: Optional[List[Dict[str, Any]]] = None
                  ) -> "CompiledNetwork":
        """Decode an artifact document.  Its format, version and checksum
        are always checked; ``verify=True`` (default) also statically
        verifies the embedded plan.  A plan the port tuned needs `tuned`,
        its sidecar's tune entries, which are verified and must cover
        every op of the plan.  Raises `VerificationError` (a ValueError)
        with the reference's rule ids on any error."""
        from repro_torch.analysis import raise_on_error, verify_artifact
        raise_on_error(verify_artifact(doc, stats=False, plan=verify),
                       "artifact")
        plan = CoexecPlan.from_json(doc["plan"], verify=False)
        _check_tune_tag(plan, tuned)
        if tuned is not None:
            _check_tuned(plan, tuned)
        return CompiledNetwork(plan=plan,
                               target=Target.from_json(doc["target"]),
                               mode=doc["mode"], tuned=tuned)

    def save(self, path: Union[str, Path]) -> Path:
        """Write the shippable artifact (target + plan + checksum) as JSON,
        byte for byte as the reference writes it; `load` round-trips it.
        A tuned network also writes its tune entries beside it
        (`runtime.autotune.sidecar_path`)."""
        from repro_torch.runtime.autotune import sidecar_path
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1))
        if self.tuned is not None:
            sidecar_path(path).write_text(json.dumps(self.tuned, indent=1))
        return path

    @staticmethod
    def load(path: Union[str, Path], *,
             verify: bool = True) -> "CompiledNetwork":
        """Load a saved artifact (see `from_json`; ``verify=False`` to
        inspect a quarantined artifact anyway), with its sidecar of tune
        entries where the port tuned it: a missing sidecar raises."""
        from repro_torch.runtime.autotune import (sidecar_path,
                                                  tune_cache_version)
        path = Path(path)
        doc = json.loads(path.read_text())
        tuned = None
        tag = ((doc.get("plan") or {}).get("provenance") or {}).get("tune")
        if tag == tune_cache_version():
            side = sidecar_path(path)
            if not side.exists():
                raise _artifact_error(
                    f"{path} was tuned for the port's Hopper kernels "
                    f"({tag}); its launches belong in its sidecar {side},"
                    f" which is missing")
            tuned = json.loads(side.read_text())
        return CompiledNetwork.from_json(doc, verify=verify, tuned=tuned)


def _artifact_error(message: str):
    from repro_torch.analysis import SEV_ERROR, Diagnostic, VerificationError
    return VerificationError("artifact", [Diagnostic(
        SEV_ERROR, "artifact.format", "", message)])


def _check_tune_tag(plan: CoexecPlan, tuned) -> None:
    """A plan tuned by the port names the launch table its launches were
    chosen in: another version's launches are not this port's to run."""
    from repro_torch.runtime.autotune import TUNE_KERNELS, tune_cache_version
    tag = plan.provenance.tune
    if tag.startswith(f"{TUNE_KERNELS}-") and tag != tune_cache_version():
        raise _artifact_error(
            f"plan {plan.key} was tuned against Hopper launch table {tag}; "
            f"this port's is {tune_cache_version()}: compile it again with "
            f"tune=True")
    if tuned is not None and tag != tune_cache_version():
        raise _artifact_error(f"tune entries given for plan {plan.key}, "
                              f"which the port did not tune (tune={tag!r})")


def _check_tuned(plan: CoexecPlan, tuned) -> None:
    """A tuned plan's sidecar: a list of the port's tune entries, each one
    verified (`verify_tune_entry`), covering every op of the plan."""
    from repro_torch.analysis import raise_on_error, verify_tune_entry
    from repro_torch.runtime.autotune import TUNE_KERNELS, entry_op
    if not isinstance(tuned, list):
        raise _artifact_error("a tuned artifact's sidecar is a JSON list of "
                              "tune entries")
    diags = []
    for i, doc in enumerate(tuned):
        if not isinstance(doc, dict) or doc.get("kernels") != TUNE_KERNELS:
            raise _artifact_error(f"sidecar entry #{i} is not a Hopper tune "
                                  f"entry")
        diags.extend(dataclasses.replace(d, node=f"#{i}")
                     for d in verify_tune_entry(doc))
    raise_on_error(diags, "tune sidecar")
    have = {entry_op(doc) for doc in tuned}
    missing = sorted({op_label(d.op) for d in plan.decisions
                      if d.op not in have})
    if missing:
        raise _artifact_error(f"the sidecar has no tune entry for "
                              f"{missing}")


# ---------------------------------------------------------- plan portfolio

PORTFOLIO_FORMAT = "repro.plan_portfolio"
PORTFOLIO_VERSION = 1

#: default (batch, seq) buckets for `compile_portfolio`
DEFAULT_BUCKETS = ((1, 64), (4, 64), (4, 256))


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One (batch, seq) serving shape a portfolio holds a plan for.

    Ordering is lexicographic (batch, then seq): `select` relies on it to
    pick the *smallest* bucket that covers a step."""

    batch: int
    seq: int

    @property
    def tag(self) -> str:
        """The provenance tag folded into the plan digest."""
        return f"b{self.batch}s{self.seq}"

    def covers(self, batch: int, seq: int) -> bool:
        return self.batch >= batch and self.seq >= seq


class PlanPortfolio:
    """One compiled plan per (batch, seq) bucket, as the reference's.

    `select(batch, seq)` returns the smallest bucket that covers the
    step's live shape (the largest bucket when nothing covers it) with its
    `CompiledNetwork`, whose memoized executors make repeated selections
    free.  `replace()` swaps one bucket's entry in place (the replan
    path).  Serializes like `CompiledNetwork` (one checksummed JSON
    document embedding every entry, byte for byte the reference's);
    loaded portfolios carry no predictors, so they can run but not
    replan."""

    def __init__(self, model: str, target: Target,
                 entries: Dict[Bucket, CompiledNetwork], *,
                 mode: str = MODE_PREDICTED):
        if not entries:
            raise ValueError("a portfolio needs at least one bucket")
        self.model = model
        self.target = target
        self.mode = mode
        self.entries = dict(sorted(entries.items()))

    @property
    def buckets(self) -> List[Bucket]:
        return list(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:
        tags = ",".join(b.tag for b in self.buckets)
        return (f"PlanPortfolio(model={self.model!r}, "
                f"device={self.target.device!r}, buckets=[{tags}])")

    def select(self, batch: int, seq: int) -> Tuple[Bucket, CompiledNetwork]:
        """Smallest bucket covering (batch, seq); the largest bucket when
        none covers (an oversized step is served by the biggest plan
        rather than refused)."""
        for b in self.buckets:                   # sorted ascending
            if b.covers(batch, seq):
                return b, self.entries[b]
        b = self.buckets[-1]
        return b, self.entries[b]

    def replace(self, bucket: Bucket, compiled: CompiledNetwork) -> None:
        """Swap one bucket's compiled plan in place (post-replan)."""
        if bucket not in self.entries:
            raise KeyError(f"unknown bucket {bucket.tag}")
        self.entries[bucket] = compiled

    def can_replan(self) -> bool:
        """Whether entries carry predictors (in-process compiles do;
        portfolios loaded from disk do not)."""
        return all(c.predictors is not None for c in self.entries.values())

    # ------------------------------------------------------------- codecs
    def to_json(self) -> Dict[str, Any]:
        doc = {"format": PORTFOLIO_FORMAT, "version": PORTFOLIO_VERSION,
               "model": self.model, "mode": self.mode,
               "target": self.target.to_json(),
               "entries": [{"batch": b.batch, "seq": b.seq,
                            "artifact": c.to_json()}
                           for b, c in self.entries.items()]}
        doc["checksum"] = _portfolio_checksum(doc)
        return doc

    @staticmethod
    def from_json(doc: Dict[str, Any], *,
                  verify: bool = True) -> "PlanPortfolio":
        """Decode a portfolio document.  Its format, version, checksum and
        every entry's artifact checks are always applied; ``verify=True``
        (default) also statically verifies every embedded plan and the
        entries' bucket tags.  Raises `VerificationError` (a ValueError)
        with the reference's rule ids on any error."""
        from repro_torch.analysis import raise_on_error, verify_portfolio
        raise_on_error(verify_portfolio(doc, stats=False, plan=verify),
                       "portfolio")
        entries = {
            Bucket(e["batch"], e["seq"]):
                CompiledNetwork.from_json(e["artifact"], verify=False)
            for e in doc["entries"]}
        return PlanPortfolio(model=doc["model"],
                             target=Target.from_json(doc["target"]),
                             entries=entries, mode=doc["mode"])

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1))
        return path

    @staticmethod
    def load(path: Union[str, Path], *,
             verify: bool = True) -> "PlanPortfolio":
        """Load a saved portfolio (see `from_json`; ``verify=False`` skips
        the static verification of the embedded plans)."""
        return PlanPortfolio.from_json(json.loads(Path(path).read_text()),
                                       verify=verify)


def _portfolio_checksum(doc: Dict[str, Any]) -> str:
    # the reference's digest, key for key
    body = {k: doc.get(k) for k in ("format", "version", "model", "mode",
                                    "target", "entries")}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def compile_portfolio(model, target: Target, *,
                      buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
                      blocks: int = 1,
                      cache: Union[PlanCache, str, Path] = DEFAULT_CACHE_DIR,
                      predictors=None,
                      samples: int = 400, estimators: int = 60,
                      predictor_cache: Optional[Union[str, Path]] = None
                      ) -> PlanPortfolio:
    """Compile one `CoexecPlan` per (batch, seq) bucket of a model graph,
    as `repro.compile_portfolio` does (the same document, byte for byte).

    `model` is a model-graph name or `ModelConfig` (legacy unit networks
    have no batch/seq knobs).  Each bucket lowers through
    `graph.from_model(model, blocks=blocks, cache_len=seq, batch=batch)`
    and compiles through the cached path with the bucket tag folded into
    provenance, so compiling the same portfolio again, in either package,
    is all warm hits.  The predictor pair is trained (or loaded) once and
    shared across buckets."""
    from repro_torch.graph.frontends import from_model, resolve_config
    cfg = resolve_config(model)
    seen = set()
    parsed: List[Bucket] = []
    for batch, seq in buckets:
        b = Bucket(int(batch), int(seq))
        if b.batch < 1 or b.seq < 1:
            raise ValueError(f"bucket {b.tag}: batch and seq must be >= 1")
        if b in seen:
            raise ValueError(f"duplicate bucket {b.tag}")
        seen.add(b)
        parsed.append(b)
    if predictors is None:
        kinds: Tuple[str, ...] = ("linear", "conv")
        probe = from_model(cfg, blocks=blocks, cache_len=parsed[0].seq,
                           batch=parsed[0].batch)
        kinds += tuple(sorted({n.kind for n in probe if n.op is not None
                               and n.kind in ("attention", "ssm")}))
        predictors = _trained_mux_predictors(
            target.device, target.threads, samples=samples,
            estimators=estimators, cache_dir=predictor_cache, kinds=kinds)
    entries = {}
    for b in parsed:
        graph = from_model(cfg, blocks=blocks, cache_len=b.seq,
                           batch=b.batch)
        entries[b] = compile(graph, target, mode=MODE_PREDICTED,
                             cache=cache, predictors=predictors,
                             bucket=b.tag)
    return PlanPortfolio(model=cfg.name, target=target, entries=entries)
