"""Plan execution runtime: run a compiled `CoexecPlan` on torch devices.

`PlanExecutor` walks the plan's op graph in topological order and lowers
every node to computation on the co-execution groups (`core/coexec.py`).
An op node runs through ONE call, `_apply`, in both walks:

  * a **co-executed** node runs the split lowering the kernel registry
    holds for its (unit, axis), resolved and packed once at load: conv
    and linear along their output channels (the split taken verbatim from
    the plan's decision, GPU share -> fast group), attention and ssm along
    their typed axis (head, kv-block, ssm-state).  Channel, head and
    ssm-state splits leave a group-local result; a kv-block split merges
    its two sides itself and leaves a materialized tensor;
  * an **exclusive** node (all channels on one side), and every node with
    a single group, runs unsplit through its registered lowering's kernel;
  * gather-elision is a *graph property* (`_elides`): a split node's
    output stays **group-local** iff its **sole consumer** is a compatible
    split node, which rebuilds its input on its own streams.  An explicit
    reshard (`gather_stacked`) happens only at true boundaries: pool/add
    nodes, exclusive nodes, shape-adapting transitions, fan-out and the
    final output — and a fanned-out split output is gathered exactly once;
  * **pool** nodes lower to max or global-average pooling, **add** nodes
    sum their materialized producers.

Where an op node's declared input shape disagrees with the producing
activation (ResNet projection shortcuts in the legacy unit chains), the
executor re-materializes the declared shape deterministically (tile +
crop, `_adapt`), and the unsplit oracle (`run_oracle`) applies the same
adaptation.  Linear inputs flatten from the NHWC activation, as in the
reference.

Parameters are drawn once, in spec order, through `registry.init_weight`
— the same numpy arrays as the reference executor for the same seed — or
carried across from the reference with `load_params`.  `dtype` (float32
or bfloat16, as in the reference) is the executor's one activation and
parameter type: the fp32 draws, the inputs and `load_params` are cast to
it, every kernel runs its instantiation for it (accumulating in fp32),
and `run_oracle` computes in it too, as the reference's oracle does.

Every node is timed into a `MeasurementRecord`, built by `_record` from
constants computed once per executor: the walk synchronizes the device
after each node (one sync point per node plus the terminal one, as the
reference blocks per node), so `wall_us` is the node's device time plus
its host overhead.

`run(fused=True)` takes the segment walk instead (`runtime/segments.py`):
one program per segment of the plan's partition, each calling `_apply` for
its members, with one sync per segment; `segments.captured` decides which
programs the card captures once as a CUDA graph and replays per request.
Its outputs are bit-identical to the per-node walk's.  Captured graphs
hold the weights' addresses, so `load_params` drops them; the next fused
run captures again.
"""
from __future__ import annotations

import dataclasses
import math
import platform
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.coexec import (Group, GroupLocal, SplitPlan,
                                     coexec_groups, gather_stacked,
                                     resolve_device)
from repro_torch.core.networks import pool_out_edge
from repro_torch.graph.ir import Graph
from repro_torch.kernels import registry
from repro_torch.measure.record import (MODE_ADD, MODE_COEXEC,
                                        MODE_EXCLUSIVE, MODE_POOL,
                                        SOURCE_EXECUTOR, SOURCE_FUSED,
                                        MeasurementRecord,
                                        usable_for_fidelity)
from repro_torch.runtime.plan import CoexecPlan, ExecSpec, spec_label
from repro_torch.runtime.spans import span

# -------------------------------------------------------------- reporting


@dataclasses.dataclass
class ExecutionReport:
    """Per-op measurement records + reshard accounting for one plan run."""

    device: str                  # the plan's (simulated) target device
    network_fingerprint: str
    chain: bool
    split_capable: bool
    timings: List[MeasurementRecord]
    reshard_points: int
    elided: int
    fused: bool = False          # segment walk (True) vs per-node walk
    sync_points: int = 0         # device syncs issued by the walk
    #: fused runs: per-segment wall, in partition order (the member
    #: records' wall_us is this attributed pro rata by pred_us)
    segment_wall_us: List[float] = dataclasses.field(default_factory=list)

    @property
    def wall_us(self) -> float:
        return sum(t.wall_us for t in self.timings)

    @property
    def predicted_us(self) -> float:
        return sum(t.pred_us for t in self.timings)

    def count(self, mode: str) -> int:
        return sum(1 for t in self.timings if t.mode == mode)

    def fidelity_error(self) -> float:
        """Σ |log(wall/pred)| over the usable records: the one metric
        implementation (`repro_torch.measure.fidelity_error`), also what
        the Calibrator and `python -m repro_torch calibrate` report."""
        from repro_torch.measure.calibrate import fidelity_error
        return fidelity_error(self.timings)

    def mean_log_ratio(self) -> Optional[float]:
        """Mean signed log(wall/pred) over the usable records (None when
        nothing is comparable)."""
        ratios = [math.log(t.wall_us / t.pred_us) for t in self.timings
                  if usable_for_fidelity(t)]
        if not ratios:
            return None
        return sum(ratios) / len(ratios)

    def fidelity_summary(self) -> str:
        ratio = (f"(x{self.wall_us / self.predicted_us:.2f})"
                 if self.predicted_us > 0.0
                 else "(ratio n/a: no predicted latency)")
        syncs = (f"{len(self.segment_wall_us)} segments "
                 f"({self.sync_points} syncs), " if self.fused
                 else f"{self.sync_points} syncs, ")
        return (f"fidelity: {len(self.timings)} units "
                f"({self.count(MODE_COEXEC)} co-executed, "
                f"{self.count(MODE_EXCLUSIVE)} exclusive, "
                f"{self.count(MODE_POOL)} pool), {syncs}"
                f"{self.reshard_points} reshard points "
                f"({self.elided} elided), "
                f"executed {self.wall_us / 1e3:.1f} ms vs predicted "
                f"{self.predicted_us / 1e3:.1f} ms {ratio}")

    def to_json(self) -> Dict[str, Any]:
        return {"device": self.device,
                "network_fingerprint": self.network_fingerprint,
                "chain": self.chain,
                "split_capable": self.split_capable,
                "reshard_points": self.reshard_points,
                "elided": self.elided,
                "fused": self.fused,
                "sync_points": self.sync_points,
                "segment_wall_us": list(self.segment_wall_us),
                "wall_us": self.wall_us,
                "predicted_us": self.predicted_us,
                "timings": [t.to_json() for t in self.timings]}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ExecutionReport":
        return ExecutionReport(
            device=d["device"],
            network_fingerprint=d["network_fingerprint"],
            chain=d["chain"], split_capable=d["split_capable"],
            timings=[MeasurementRecord.from_json(t) for t in d["timings"]],
            reshard_points=d["reshard_points"], elided=d["elided"],
            fused=d.get("fused", False),
            sync_points=d.get("sync_points", 0),
            segment_wall_us=list(d.get("segment_wall_us", [])))


# ------------------------------------------------------------- activations

_Act = Union[torch.Tensor, GroupLocal]


def _fit_axis(x: torch.Tensor, axis: int, size: int, *, align: int = 8,
              adapt: bool = False) -> torch.Tensor:
    """Re-materialize one axis to `size`.

    Strict by default: the only tolerated mismatch is cropping away
    alignment padding (`size < cur <= size` rounded up to `align`);
    anything else raises, since silently tiling values over a wiring
    mistake corrupts results without failing a test.  `adapt=True` opts
    in to the deterministic tile + crop of declared shape adaptation.
    """
    cur = x.shape[axis]
    if cur == size:
        return x
    if not adapt:
        padded = -(-size // align) * align
        if not (size < cur <= padded):
            raise ValueError(
                f"axis {axis} has size {cur}, expected {size} (or its "
                f"alignment padding up to {padded}); shapes do not chain "
                "and this call site does not adapt")
    if cur < size:
        reps = [1] * x.dim()
        reps[axis] = -(-size // cur)
        x = x.repeat(*reps)
    return x.narrow(axis, 0, size)


# --------------------------------------------------------------- executor

#: the activation/parameter types an executor runs in (the reference's)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """float32 or bfloat16, given as a torch dtype or by name."""
    if isinstance(dtype, torch.dtype) and dtype in DTYPES.values():
        return dtype
    if isinstance(dtype, str) and dtype in DTYPES:
        return DTYPES[dtype]
    raise ValueError(f"unsupported dtype {dtype!r}; choices: "
                     f"{list(DTYPES)}")


class PlanExecutor:
    """Executes a compiled `CoexecPlan` on the co-execution groups.

    `device` defaults to CUDA (and raises where there is none); pass
    `device="cpu"` to run on the CPU.  `groups` overrides the default two
    groups on that device (one group = every node exclusive).  `dtype`
    (float32 or bfloat16) is what parameters and activations are held in.
    `launches` maps an op to its tuned Hopper launch (`kernels.tiles`, a
    tuned compile's); every node of that op passes it to its kernel, each
    side of a split fitted to its own extents, in both walks.  Ops it does
    not name launch what their kernels' planners pick.
    """

    def __init__(self, plan: CoexecPlan, *,
                 device: Union[str, torch.device, None] = None,
                 groups: Optional[Sequence[Group]] = None, seed: int = 0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 launches: Optional[Dict[Any, Any]] = None):
        plan.check_graph()
        self.plan = plan
        self.dtype = resolve_dtype(dtype)
        self.specs: List[ExecSpec] = plan.exec_specs()
        self.launches = [None if spec.op is None
                         else (launches or {}).get(spec.op)
                         for spec in self.specs]
        self.graph: Graph = plan.graph_ir()
        self._pos = {n.id: i for i, n in enumerate(self.graph)}
        # each op node's unsplit lowering (importing its kernels now)
        self._lowerings = [None if spec.op is None
                           else registry.get_lowering(spec.unit)
                           for spec in self.specs]
        if groups is None:
            self.device = resolve_device(device)
            self.groups: Tuple[Group, ...] = coexec_groups(self.device)
        else:
            self.groups = tuple(groups)
            self.device = self.groups[0].device
        self.split_capable = len(self.groups) == 2
        prov = plan.provenance
        # what every measurement record of this executor carries
        self._record_fields = dict(
            device=prov.device, backend=str(self.device),
            host=platform.node(), plan_key=plan.key,
            network_fingerprint=prov.network_fingerprint)
        self._labels = [spec_label(spec) for spec in self.specs]
        self.last_report: Optional[ExecutionReport] = None
        self._warmed: set = set()
        self._programs: Dict[Tuple[int, ...], list] = {}
        self._input_seed = seed + 1

        rng = np.random.default_rng(seed)
        self.load_params([
            None if spec.op is None
            else registry.get(spec.unit).init_weight(spec.op, rng)
            for spec in self.specs])

    def load_params(self, arrays: Sequence[Optional[np.ndarray]]) -> None:
        """Take a full parameter list in spec order — e.g. the reference
        executor's `[np.asarray(p) for p in exe.params]` — in the reference
        layouts ((C_in, C_out) linear, HWIO conv weights, the stacked
        (2, S, KV, hd) KV cache of an attention node, the flat
        B/C/dt/a/state0 vector of an ssm node), move it to this executor's
        device in its dtype, and re-pack the split weights.  Captured
        segment programs read the old weights' addresses, so every one is
        dropped: the next fused run captures again."""
        if len(arrays) != len(self.specs):
            raise ValueError(f"expected {len(self.specs)} parameters (one "
                             f"per schedule entry), got {len(arrays)}")
        params: List[Optional[torch.Tensor]] = []
        for spec, a in zip(self.specs, arrays):
            if spec.op is None:
                if a is not None:
                    raise ValueError(f"node {spec.node_id} ({spec.unit}) "
                                     f"takes no parameter")
                params.append(None)
                continue
            want = tuple(registry.get(spec.unit).weight_shape(spec.op))
            arr = np.array(a, dtype=np.float32)
            if arr.shape != want:
                raise ValueError(f"node {spec.node_id}: parameter shape "
                                 f"{arr.shape} != {want}")
            params.append(torch.from_numpy(arr).to(self.device, self.dtype))
        self._programs = {}
        self._warmed = {key for key in self._warmed if not key[1]}
        self.params = params
        # resolve each co-executed node's split lowering and pre-split its
        # weights once, never inside the timed walk: (lowering, split,
        # packed) per spec (per-group channel slices, KV-head slices, cache
        # blocks, per-head SSM operands)
        self._splits: List[Optional[Tuple[registry.SplitLowering,
                                          SplitPlan, object]]] = []
        for spec, w in zip(self.specs, params):
            if not (self.split_capable and spec.coexec):
                self._splits.append(None)
                continue
            low = registry.get_split_lowering(spec.unit, spec.axis)
            self._splits.append((low, *low.pack(w, spec.op, spec.c_fast,
                                                self.groups)))

    # ------------------------------------------------------------- inputs
    def input_template(self) -> torch.Tensor:
        """A seeded input matching the first source node's declared shape
        (the reference's draw: every call returns the same values)."""
        src = self.graph.sources[0]
        shape = tuple(registry.get(src.kind).input_shape(src.op))
        if src.kind == "conv":
            shape = (1,) + shape
        rng = np.random.default_rng(self._input_seed)
        x = rng.standard_normal(shape).astype(np.float32)
        return self._tensor(x)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, self.dtype)
        return torch.from_numpy(np.array(x, np.float32)).to(self.device,
                                                            self.dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------- elementaries
    def _materialize(self, act: _Act) -> Tuple[torch.Tensor, int]:
        """Explicit reshard of a group-local result (1 sync point), no-op
        on plain activations."""
        if isinstance(act, GroupLocal):
            return gather_stacked(act), 1
        return act, 0

    def _adapt(self, x: torch.Tensor, spec: ExecSpec) -> torch.Tensor:
        """Re-materialize a plain activation to the node's declared input
        shape (identity when shapes already chain)."""
        op = spec.op
        if spec.unit == "conv":
            if x.dim() == 2:                  # linear -> conv (total)
                x = x.reshape(1, 1, *x.shape)
            x = _fit_axis(x, 1, op.H_in, adapt=True)
            x = _fit_axis(x, 2, op.W_in, adapt=True)
            return _fit_axis(x, 3, op.C_in, adapt=True)
        # 2D (rows, channels) contracts: flatten the NHWC activation
        shape = tuple(registry.get(spec.unit).input_shape(op))
        flat = x.reshape(-1)
        flat = _fit_axis(flat, 0, int(np.prod(shape)), adapt=True)
        return flat.reshape(shape)

    def _pool(self, x: torch.Tensor, pool_bytes: int) -> torch.Tensor:
        """Global average pool when the recorded output is one value per
        channel, else max-pool down to the recorded edge."""
        c = x.shape[-1]
        edge = pool_out_edge(pool_bytes, c)
        if edge <= 1:
            return x.mean(dim=(1, 2), keepdim=True)
        r = max(1, x.shape[1] // edge)
        x = x[:, :edge * r, :edge * r, :]
        y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=r, stride=r)
        return y.permute(0, 2, 3, 1).contiguous()

    def _apply(self, i: int, x_in: _Act, x_plan: Optional[SplitPlan], *,
               split: bool, gather: bool = False) -> _Act:
        """Op node `i`'s one call, with its tuned launch: unsplit through its
        registered lowering's kernel, or (`split`) through its registered
        split lowering, gathered iff `gather`.  `x_plan` is given exactly
        when `x_in` is a producer's group-local result."""
        spec, launch = self.specs[i], self.launches[i]
        if not split:
            return self._lowerings[i].kernel(x_in, self.params[i], spec.op,
                                             launch=launch)
        low, plan, packed = self._splits[i]
        return low.run(x_in, packed, plan, self.groups, spec.op, spec.c_fast,
                       gather=gather, x_plan=x_plan, launch=launch)

    def _elides(self, i: int, src: str, shape: Tuple[int, ...]) -> bool:
        """Gather-elision: op node `i` consumes its producer `src`'s
        group-local result of logical `shape` directly iff it splits too,
        it is that producer's sole consumer, and its declared input shape
        is exactly `shape` (any adaptation is a true boundary)."""
        spec = self.specs[i]
        if not (self.split_capable and spec.coexec
                and len(self.graph.consumers(src)) == 1):
            return False
        op = spec.op
        if spec.unit == "conv":
            return shape == (1, op.H_in, op.W_in, op.C_in)
        return shape == tuple(registry.get(spec.unit).input_shape(op))

    def _record(self, i: int, mode: str, chained: bool, gathered: bool,
                wall_us: float, source: str, segment: int
                ) -> MeasurementRecord:
        """Node `i`'s measurement record (either walk's)."""
        spec = self.specs[i]
        return MeasurementRecord(
            index=i, unit=spec.unit, label=self._labels[i], mode=mode,
            c_fast=spec.c_fast, c_slow=spec.c_slow, chained_input=chained,
            gathered_output=gathered, wall_us=wall_us,
            pred_us=spec.pred_total_us, op=spec.op, source=source,
            node_id=self.graph.nodes[i].id, segment=segment,
            **self._record_fields)

    # ------------------------------------------------------------ segments
    def segment_programs(self, x_shape: Optional[Tuple[int, ...]] = None):
        """The `SegmentProgram` list for input shape `x_shape` (default:
        the input template's), memoized per shape; on CUDA each program
        the capture rule names is captured when the list is first built."""
        if x_shape is None:
            x_shape = tuple(self.input_template().shape)
        x_shape = tuple(x_shape)
        if x_shape not in self._programs:
            from repro_torch.runtime.segments import compile_segments
            self._programs[x_shape] = compile_segments(self, x_shape)
        return self._programs[x_shape]

    # ----------------------------------------------------------------- run
    def run(self, x=None, *, chain: bool = True, warmup: bool = False,
            fused: bool = False) -> Tuple[torch.Tensor, ExecutionReport]:
        """Execute the plan; returns (output, ExecutionReport).

        `warmup=True` runs the schedule once untimed first (kernel builds,
        cuDNN algorithm selection, allocator growth, and for the fused
        walk the capture of its graphs), once per executor and (chain,
        fused) pair; only the timed run lands on `last_report`.
        `chain=False` gathers after every co-executed op (no elision).

        `fused=True` takes the segment walk: one program per segment of
        the plan's partition (one CUDA graph replay on the card), one
        device sync per segment, outputs bit-identical to the per-node
        walk, which stays the `fused=False` reference.  Without warm-up,
        the first fused run captures before its first segment is timed.
        """
        if fused and not chain:
            raise ValueError(
                "fused=True implies chaining: chain=False is the "
                "gather-every-op reference walk and has no fused form")
        key = (chain, fused)

        def step():
            if fused:
                return self._execute_fused(x)
            return self._execute(x, chain=chain)

        if warmup and key not in self._warmed:
            step()                               # untimed: not published
        y, report = step()
        self._warmed.add(key)
        self.last_report = report
        return y, report

    def _execute(self, x=None, *, chain: bool = True
                 ) -> Tuple[torch.Tensor, ExecutionReport]:
        x0 = self.input_template() if x is None else self._tensor(x)
        acts: Dict[str, _Act] = {}
        remaining = {n.id: len(self.graph.consumers(n.id))
                     for n in self.graph}
        timings: List[MeasurementRecord] = []
        reshard = elided = 0

        def materialized(src: Optional[str]) -> torch.Tensor:
            """The gathered activation of a producer.  A group-local output
            is gathered ONCE and written back, so fan-out costs a single
            reshard no matter how many consumers follow."""
            nonlocal reshard
            if src is None:
                return x0
            act = acts[src]
            if isinstance(act, GroupLocal):
                act, r = self._materialize(act)
                reshard += r
                acts[src] = act
            return act

        for i, (node, spec) in enumerate(zip(self.graph, self.specs)):
            src = node.inputs[0] if node.inputs else None
            t0 = time.perf_counter()
            chained = False
            if spec.unit == "pool":
                mode = MODE_POOL
                out = self._pool(materialized(src), spec.pool_bytes)
            elif spec.unit == "add":
                mode = MODE_ADD
                parts = [materialized(s) for s in node.inputs]
                shapes = {tuple(p.shape) for p in parts}
                if len(shapes) != 1:
                    raise ValueError(
                        f"add node {node.id!r} joins mismatched shapes "
                        f"{sorted(shapes)}")
                out = parts[0]
                for p in parts[1:]:
                    out = out + p
            else:
                split = self.split_capable and spec.coexec
                prod_act = x0 if src is None else acts[src]
                if (isinstance(prod_act, GroupLocal) and chain
                        and self._elides(i, src, prod_act.shape)):
                    x_in, x_plan = prod_act, prod_act.split
                    chained = True
                    elided += 1
                else:
                    x_in, x_plan = self._adapt(materialized(src), spec), None
                out = self._apply(i, x_in, x_plan, split=split)
                mode = MODE_COEXEC if split else MODE_EXCLUSIVE
                if split and not chain:
                    out, r = self._materialize(out)       # sync every op
                    reshard += r
            acts[node.id] = out
            self._sync()
            timings.append(self._record(
                i, mode, chained, not isinstance(out, GroupLocal),
                (time.perf_counter() - t0) * 1e6, SOURCE_EXECUTOR,
                spec.segment))
            # free consumed producers (keep the graph output alive)
            for s in node.inputs:
                remaining[s] -= 1
                if remaining[s] == 0:
                    acts.pop(s, None)

        # the terminal sync point: with chaining, the last co-executed op's
        # gather is deferred to here — charge it to that op
        t0 = time.perf_counter()
        y, r = self._materialize(acts[self.graph.output.id])
        self._sync()
        reshard += r
        if timings and r:
            timings[-1].gathered_output = True
            timings[-1].wall_us += (time.perf_counter() - t0) * 1e6
        prov = self.plan.provenance
        report = ExecutionReport(
            device=prov.device,
            network_fingerprint=prov.network_fingerprint,
            chain=chain, split_capable=self.split_capable, timings=timings,
            reshard_points=reshard, elided=elided,
            sync_points=len(timings) + 1)
        return y, report

    def _execute_fused(self, x=None) -> Tuple[torch.Tensor, ExecutionReport]:
        """The segment walk: one program and one device sync per segment;
        a captured program is one graph replay on CUDA.

        The members of a fused segment no longer sync one by one, so each
        member record carries the segment wall attributed pro rata by
        predicted latency (equal shares when the segment has none), with
        `source="fused"` and its segment index: member walls sum to the
        segment wall.

        While the profiler runs, the walk is traced as one
        `repro_torch.walk` span (`runtime/spans.py`) holding one span per
        segment (`SegmentProgram.span`), in partition order; each holds
        the segment's `repro_torch.sync` and, after it, its
        `repro_torch.records`.  A segment span less its records is the
        interval `segment_wall_us` times, on the trace's clock."""
        with span("repro_torch.walk"):
            return self._walk_segments(x)

    def _walk_segments(self, x) -> Tuple[torch.Tensor, ExecutionReport]:
        x0 = self.input_template() if x is None else self._tensor(x)
        programs = self.segment_programs(tuple(x0.shape))
        pos = self._pos
        out_id = self.graph.output.id
        acts: Dict[Optional[str], torch.Tensor] = {None: x0}
        timings: List[MeasurementRecord] = []
        segment_wall: List[float] = []
        reshard = elided = 0

        for sp in programs:
            with span(sp.span):
                t0 = time.perf_counter()
                out = sp([acts[s] for s in sp.ext_inputs])
                if sp.graph is not None and sp.node_ids[-1] == out_id:
                    # the graph's static output: the next request's replay
                    # would overwrite what this one returns
                    out = out.clone()
                with span("repro_torch.sync"):
                    self._sync()
                wall = (time.perf_counter() - t0) * 1e6
                segment_wall.append(wall)
                reshard += sp.gathers
                elided += sp.elided
                # convexity: only a segment's last node is consumed
                # downstream
                acts[sp.node_ids[-1]] = out
                with span("repro_torch.records"):
                    preds = [self.specs[pos[n]].pred_total_us
                             for n in sp.node_ids]
                    total = sum(preds)
                    for nid, pred in zip(sp.node_ids, preds):
                        share = (wall * pred / total if total > 0.0
                                 else wall / len(preds))
                        timings.append(self._record(
                            pos[nid], sp.modes[nid], sp.chained[nid],
                            sp.gathered[nid], share, SOURCE_FUSED, sp.index))

        prov = self.plan.provenance
        report = ExecutionReport(
            device=prov.device,
            network_fingerprint=prov.network_fingerprint,
            chain=True, split_capable=self.split_capable, timings=timings,
            reshard_points=reshard, elided=elided, fused=True,
            sync_points=len(programs), segment_wall_us=segment_wall)
        return acts[out_id], report

    def run_oracle(self, x=None) -> torch.Tensor:
        """The unsplit reference: every node through its plain oracle, with
        identical params and shape adaptation — what split execution must
        match elementwise."""
        x0 = self.input_template() if x is None else self._tensor(x)
        acts: Dict[str, torch.Tensor] = {}
        for node, spec, w in zip(self.graph, self.specs, self.params):
            src = acts[node.inputs[0]] if node.inputs else x0
            if spec.unit == "pool":
                acts[node.id] = self._pool(src, spec.pool_bytes)
            elif spec.unit == "add":
                out = acts[node.inputs[0]]
                for s in node.inputs[1:]:
                    out = out + acts[s]
                acts[node.id] = out
            else:
                low = registry.get_lowering(spec.unit)
                acts[node.id] = low.oracle(self._adapt(src, spec), w,
                                           spec.op)
        return acts[self.graph.output.id]
