"""The segment compiler: lower a plan's schedule into programs, one per
segment, most of them captured and replayed as one CUDA graph each.

The per-node walk (`PlanExecutor._execute`) dispatches every node from
Python and synchronizes after each.  The plan's `segment_partition()`
(`Graph.segments`) groups the schedule into maximal runs of channel-split
nodes and the residual adds between them; `compile_segments` turns each
fused run into ONE program, the port's counterpart of the reference's one
`jax.jit` program per segment (`src/repro/runtime/segments.py`):

  * a layout pass walks the partition over shapes only, with the per-node
    walk's own decisions (the chaining predicate, `_adapt`, the crops), and
    records one instruction per member node;
  * `_emit` closes the instruction list into `fn(ext_vals)`, which runs
    the segment on the executor's groups through the per-node walk's own
    node call (`PlanExecutor._apply`) and `gather_stacked`, with the same
    tuned launches, so both compute bit-identical values (and a capture
    holds the tuned launches); a chained edge hands the producer's
    `GroupLocal` to the consumer, an interior reshard gathers it, and the
    segment ends in its one boundary gather.

Every singleton gets an `fn` too, the per-node walk's one call: `_pool`,
or `_adapt` then `_apply` (a typed-axis split, which the partition keeps
out of fused runs, gathered or merged by its own lowering).

One rule, `captured`, decides which programs run as a CUDA graph on the
card: fused segments, pools and exclusive singletons of the units fused
segments capture (`CAPTURED_UNITS`).  Each is captured once into a
`torch.cuda.CUDAGraph` that reads static input buffers (`_capture`); a
replay copies the external inputs into them and launches the whole
segment, both streams and the programmatic second passes included, as one
graph.  What the captured work allocates (activations, `split_matmul`'s
workspaces) comes from the graph's private memory pool and lives as long
as the graph.  Typed-axis splits and exclusive singletons of other units
run their `fn` eagerly, as every program does on the CPU: there is no
second code path for the arithmetic.  A captured graph holds the weights'
addresses, so `PlanExecutor.load_params` drops every program.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.coexec import GroupLocal, gather_stacked
from repro_torch.graph.ir import SEGMENT_EXCLUSIVE, SEGMENT_FUSED, SEGMENT_POOL
from repro_torch.kernels import registry
from repro_torch.measure.record import (MODE_ADD, MODE_COEXEC,
                                        MODE_EXCLUSIVE, MODE_POOL)
from repro_torch.runtime.spans import span

Shape = Tuple[int, ...]

#: the units whose exclusive singletons are captured: those that fused
#: segments already capture (cuDNN and Winograd convs, `split_matmul`)
CAPTURED_UNITS = ("conv", "linear")


def captured(kind: str, mode: str, unit: str) -> bool:
    """The capture rule: whether a program of segment `kind` whose first
    member runs in `mode` and is of `unit` runs as a CUDA graph on the
    card.  Fused segments and pools do; an exclusive-segment singleton
    does iff it runs unsplit and its unit is in `CAPTURED_UNITS`
    (typed-axis splits and other units run eagerly)."""
    return kind != SEGMENT_EXCLUSIVE or (mode == MODE_EXCLUSIVE
                                         and unit in CAPTURED_UNITS)


@functools.lru_cache(maxsize=None)
def launch_counters() -> Dict[str, Any]:
    """The kernel wrappers, by name, whose `.launches` count the launches
    that reach the device."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention)
    from repro_torch.kernels.split_matmul.split_matmul import split_matmul
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_scan
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul)
    return {"split_matmul": split_matmul, "hadamard_matmul": hadamard_matmul,
            "decode_attention": decode_attention,
            "ssd_chunk_scan": ssd_chunk_scan}


@dataclasses.dataclass
class SegmentProgram:
    """One executable segment of the fused walk.

    Every program carries `fn(ext_vals)`; where the capture rule
    (`captured`) holds, it also holds `fn`'s graph on CUDA.  `ext_inputs`
    names the producers the segment reads, in order (`None` is the graph
    input); the per-node maps feed the member nodes' measurement records.
    `span` names the segment's profiler span in the walk
    (`segment_span`).  `launches` are the kernel-wrapper launches one
    replay of the graph makes, credited to the wrappers' counters at
    every replay.
    """

    index: int                           # position in the partition
    kind: str                            # fused | pool | exclusive
    node_ids: Tuple[str, ...]
    ext_inputs: Tuple[Optional[str], ...]
    gathers: int                         # reshards this segment makes
    elided: int                          # chained (group-local) edges inside
    chained: Dict[str, bool]             # node id -> consumed chained input
    gathered: Dict[str, bool]            # node id -> output materialized
    modes: Dict[str, str]                # node id -> measurement mode
    span: str                            # the walk's span of the segment
    fn: Callable[[List[torch.Tensor]], torch.Tensor]
    captured: bool = False               # `captured`: a graph on CUDA
    graph: Optional[torch.cuda.CUDAGraph] = None
    static_inputs: Tuple[torch.Tensor, ...] = ()
    static_output: Optional[torch.Tensor] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __call__(self, ext_vals: List[torch.Tensor]) -> torch.Tensor:
        """Run the program on the current stream: eagerly, or as one
        replay of its graph (a `repro_torch.replay` span while the profiler
        runs).  A replay's output is the graph's static output tensor,
        which the next replay overwrites."""
        if self.graph is None:
            return self.fn(ext_vals)
        for buf, val in zip(self.static_inputs, ext_vals):
            buf.copy_(val)
        with span("repro_torch.replay"):
            self.graph.replay()
        counters = launch_counters()
        for name, n in self.launches.items():
            counters[name].launches += n
        return self.static_output


def segment_span(index: int, kind: str, node_ids: Tuple[str, ...]) -> str:
    """The walk's span name of a segment, e.g. `repro_torch.segment[10]
    fused n10..n12`: its position in the partition, kind and first and
    last member."""
    return f"repro_torch.segment[{index}] {kind} {node_ids[0]}..{node_ids[-1]}"


# ----------------------------------------------------------------- layout

def _meta_shape(fn: Callable[[torch.Tensor], torch.Tensor],
                shape: Shape) -> Shape:
    """Output shape of a one-tensor function, evaluated on the meta device
    (shapes only, nothing computed)."""
    return tuple(fn(torch.empty(shape, device="meta")).shape)


def _out_shape(spec, adapted: Shape) -> Shape:
    """An op node's output shape on an adapted input (convs keep the
    batch; the lowerings crop SAME convs to the declared edge)."""
    op = spec.op
    if spec.unit == "conv":
        return (adapted[0], op.H_out, op.W_out, op.C_out)
    return tuple(registry.get(spec.unit).output_shape(op))


def compile_segments(exe, x_shape: Shape) -> List[SegmentProgram]:
    """Lower the executor's plan into segment programs for input `x_shape`.

    The layout pass walks the partition in order, tracking each value's
    state (a materialized shape, or a group-local split output) as the
    per-node walk would, and records one instruction per fused member.
    Programs depend on the input shape (chaining is shape-exact), hence
    the per-shape memoization in `PlanExecutor.segment_programs`.  On a
    CUDA executor every `captured` program is captured here, before any
    timed run."""
    # the materialized shape of every published (cross-segment) value
    plain_shape: Dict[Optional[str], Shape] = {None: tuple(x_shape)}
    programs: List[SegmentProgram] = []
    for k, seg in enumerate(exe.plan.segment_partition()):
        layout = (_layout_fused if seg.kind == SEGMENT_FUSED
                  else _layout_singleton)
        prog = layout(exe, k, seg, plain_shape)
        first = seg.node_ids[0]
        prog.captured = captured(seg.kind, prog.modes[first],
                                 exe.specs[exe._pos[first]].unit)
        if prog.captured and exe.device.type == "cuda":
            _capture(exe, prog, [plain_shape[s] for s in prog.ext_inputs])
        programs.append(prog)
    return programs


def _layout_fused(exe, k: int, seg, plain_shape: Dict[Optional[str], Shape]
                  ) -> SegmentProgram:
    """A fused run: each member's instruction, with the per-node walk's
    own decisions (`_elides`, `_adapt`, the crops) taken over shapes, and
    the run's one `fn`."""
    graph = exe.graph
    stacked: Dict[str, Shape] = {}          # group-local value -> its shape
    local_shape: Dict[str, Shape] = {}
    instrs: List[Dict[str, Any]] = []
    ext: List[Optional[str]] = []
    gathers = elided = 0
    chained_f: Dict[str, bool] = {}
    modes: Dict[str, str] = {}

    def plain_in(src: Optional[str]) -> Shape:
        """Shape of `src` consumed materialized (counts the interior
        gather when it is a still group-local segment member)."""
        nonlocal gathers
        if src in stacked:
            local_shape[src] = stacked.pop(src)
            gathers += 1
            return local_shape[src]
        if src in local_shape:
            return local_shape[src]
        if src not in ext:
            ext.append(src)
        return plain_shape[src]

    for nid in seg.node_ids:
        node = graph.node(nid)
        i = exe._pos[nid]
        spec = exe.specs[i]
        if spec.unit == "add":
            shapes = {plain_in(s) for s in node.inputs}
            if len(shapes) != 1:
                raise ValueError(f"add node {nid!r} joins mismatched "
                                 f"shapes {sorted(shapes)}")
            local_shape[nid] = shapes.pop()
            instrs.append({"id": nid, "kind": "add",
                           "srcs": tuple(node.inputs)})
            modes[nid] = MODE_ADD
            chained_f[nid] = False
            continue
        src = node.inputs[0] if node.inputs else None
        do_split = exe.split_capable and spec.coexec
        if do_split and spec.axis != "channel":
            raise AssertionError(            # the partition keeps them out
                f"typed-axis split {nid!r} inside fused segment {k}")
        ch = src in stacked and exe._elides(i, src, stacked[src])
        if ch:
            in_shape = stacked.pop(src)
            elided += 1
        else:
            in_shape = _meta_shape(lambda v: exe._adapt(v, spec),
                                   plain_in(src))
        chained_f[nid] = ch
        out_shape = _out_shape(spec, in_shape)
        if do_split:
            stacked[nid] = out_shape
            modes[nid] = MODE_COEXEC
        else:
            local_shape[nid] = out_shape
            modes[nid] = MODE_EXCLUSIVE
        instrs.append({"id": nid, "kind": "op", "index": i, "src": src,
                       "chained": ch, "split": do_split, "spec": spec})

    last = seg.node_ids[-1]
    if last in stacked:                       # the boundary gather
        gathers += 1
        local_shape[last] = stacked.pop(last)
    if stacked:
        raise AssertionError(                 # convexity guarantees this
            f"segment {seg.node_ids} leaks group-local values "
            f"{sorted(stacked)}")
    plain_shape[last] = local_shape[last]
    gathered_f = {nid: True for nid in seg.node_ids}
    for ins in instrs:
        if ins.get("chained"):
            gathered_f[ins["src"]] = False
    return SegmentProgram(
        index=k, kind=SEGMENT_FUSED, node_ids=seg.node_ids,
        ext_inputs=tuple(ext), gathers=gathers, elided=elided,
        chained=chained_f, gathered=gathered_f, modes=modes,
        span=segment_span(k, SEGMENT_FUSED, seg.node_ids),
        fn=_emit(exe, instrs, tuple(ext)))


def _layout_singleton(exe, k: int, seg,
                      plain_shape: Dict[Optional[str], Shape]
                      ) -> SegmentProgram:
    """A pool or exclusive-segment singleton: its shape is tracked, and
    its `fn` makes the per-node walk's one call."""
    nid = seg.node_ids[0]
    node = exe.graph.node(nid)
    i = exe._pos[nid]
    spec = exe.specs[i]
    src = node.inputs[0] if node.inputs else None
    if seg.kind == SEGMENT_POOL:
        mode = MODE_POOL
        out_shape = _meta_shape(lambda v: exe._pool(v, spec.pool_bytes),
                                plain_shape[src])

        def fn(ext_vals):
            return exe._pool(ext_vals[0], spec.pool_bytes)
    else:
        # a typed-axis split co-executes here, outside any fused run: its
        # lowering merges or gathers its own sides
        split = exe.split_capable and spec.coexec
        mode = MODE_COEXEC if split else MODE_EXCLUSIVE
        out_shape = _out_shape(spec, _meta_shape(
            lambda v: exe._adapt(v, spec), plain_shape[src]))

        def fn(ext_vals):
            return exe._apply(i, exe._adapt(ext_vals[0], spec), None,
                              split=split, gather=True)
    plain_shape[nid] = out_shape
    return SegmentProgram(
        index=k, kind=seg.kind, node_ids=seg.node_ids,
        ext_inputs=(src,), gathers=0, elided=0, chained={nid: False},
        gathered={nid: True}, modes={nid: mode},
        span=segment_span(k, seg.kind, seg.node_ids), fn=fn)


# --------------------------------------------------------------- emission

def _emit(exe, instrs: List[Dict[str, Any]],
          ext_keys: Tuple[Optional[str], ...]) -> Callable:
    """Close the instruction list into `fn(ext_vals) -> the segment's
    materialized output`, `ext_vals` following `ext_keys`.  Weights are
    read from the executor at call time.  No host synchronization: on
    CUDA everything is queued on the current stream and the groups'
    streams, which rejoin the current stream at the boundary gather."""

    def program(ext_vals: List[torch.Tensor]) -> torch.Tensor:
        env: Dict[Optional[str], Any] = dict(zip(ext_keys, ext_vals))

        def plain(src: Optional[str]) -> torch.Tensor:
            v = env[src]
            if isinstance(v, GroupLocal):     # interior reshard
                v = env[src] = gather_stacked(v)
            return v

        for ins in instrs:
            if ins["kind"] == "add":
                parts = [plain(s) for s in ins["srcs"]]
                out = parts[0]
                for p in parts[1:]:
                    out = out + p
                env[ins["id"]] = out
                continue
            if ins["chained"]:
                x_in = env[ins["src"]]
                x_plan = x_in.split
            else:
                x_in = exe._adapt(plain(ins["src"]), ins["spec"])
                x_plan = None
            env[ins["id"]] = exe._apply(ins["index"], x_in, x_plan,
                                        split=ins["split"])
        return plain(instrs[-1]["id"])

    return program


# ---------------------------------------------------------------- capture

def _capture(exe, prog: SegmentProgram, shapes: List[Shape]) -> None:
    """Capture `prog.fn` into one CUDA graph over static input buffers of
    `shapes`, in the executor's dtype.

    The function runs once eagerly first, on a side stream, as PyTorch
    asks: that builds the kernels, fills the launch planners' caches,
    sets the kernels' shared-memory attributes and lets cuDNN choose its
    algorithms, so none of it happens inside the capture.  (Those eager
    launches reach the device and stay counted.)  The wrappers count the
    captured launches too, though none reaches the device until a replay:
    they are taken back off the counters and kept on `prog.launches`, to
    be credited at every replay.  A failed capture raises."""
    dev = exe.device
    static = [torch.zeros(s, device=dev, dtype=exe.dtype) for s in shapes]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        prog.fn(static)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)

    counters = launch_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = prog.fn(static)
    finally:
        held = {name: fn.launches - before[name]
                for name, fn in counters.items()}
        for name, fn in counters.items():
            fn.launches = before[name]
    prog.graph = graph
    prog.static_inputs = tuple(static)
    prog.static_output = out
    prog.launches = {name: n for name, n in held.items() if n}
