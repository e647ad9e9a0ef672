"""Cost of a step from its eager op stream: the port's counterpart of
`repro.roofline.hlo_walk`.

The reference walks the compiled HLO of a jitted step.  The port has no
HLO, so `analyze(fn)` runs `fn` on fake tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`: shapes and dtypes, no
memory) under a `TorchDispatchMode` nested inside
`torch.utils.flop_counter.FlopCounterMode`, and counts for every
dispatched op:

  * FLOPs: `FlopCounterMode`'s, 2 * out * contracting for mm, bmm and
    einsum products, as `hlo_walk` counts dots;
  * bytes: the input and output bytes of every op that is not a view
    (`func.is_view`) and returns a tensor (metadata queries such as
    `prim.device` move nothing).  Eager PyTorch materializes each op, so this counts
    what the port moves, not what XLA would fuse away;
  * collectives: operand bytes by kind of any c10d collective in the
    stream (a one-device program issues none);
  * the peak of live intermediate bytes: each op output's bytes from its
    creation until the tensor is freed.

Trip-count accounting, the counterpart of `known_trip_count`: a walk
installs itself in `core.loops`, whose `counted_range(n)` is `range(n)`
outside a walk; inside one it runs the first iteration as it is and the
second weighed by n - 1 (`_OpWalk.weighted`), and then stops.  The first runs apart because it can differ from the rest in
what autograd records (a carried state that does not require grad on
entry does after one iteration).  The weight also covers the autograd
nodes the weighed body recorded, when a backward runs them: each node
is known by its sequence number, and the ops it runs, gradient
accumulation included, take its body's weight.  So a collapsed loop's
FLOPs are the full loop's, forward and backward, and so are its bytes
without a backward; in a backward its bytes miss most of the gradient
accumulations of the tensors the loop slices (about n - 2 adds of each
one's whole gradient: the engine adds a slice's gradient to the buffer
when it arrives second, and the weighed body's arrives first).  It is meant for loops
whose iterations have equal shapes and carry only their state (the flash
key loops, the chunked WKV and SSD scans), and it is safe: a walk takes
only fake tensors and raises on a real one, so no value anyone reads is
computed by a collapsed loop.  A counted loop inside a weighed body runs
in full, weighed by the outer one.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.loops import weighing

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: c10d op names (both the functional and the in-place namespaces) by
#: the reference's collective kinds
_C10D_KINDS = {
    "all_gather": "all-gather", "allgather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "_allgather_base": "all-gather",
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "all_to_all": "all-to-all", "alltoall": "all-to-all",
    "all_to_all_single": "all-to-all", "alltoall_base": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
}

_LIFTS = (torch.ops.aten.lift_fresh.default,
          torch.ops.aten.lift_fresh_copy.default)

@dataclasses.dataclass
class CompCost:
    flops: float = 0.0
    bytes_: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    peak_live_bytes: float = 0.0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1].rstrip("_")
    return _C10D_KINDS.get(name)


def _sequence_nr() -> int:
    """The sequence number the next autograd node will take."""
    return torch._C._autograd._get_sequence_nr()


class _OpWalk(TorchDispatchMode):
    def __init__(self, flop_counter):
        super().__init__()
        self.flop_counter = flop_counter
        self.cost = CompCost()
        self.weight = 1.0
        self.live = 0
        # the weighed bodies' autograd nodes: sequence-number spans
        # [start, stop), in order, each with its body's weight
        self.starts: list = []
        self.spans: list = []

    def _op_weight(self) -> float:
        """The weight of the op being dispatched: its body's, times, in a
        backward, that of the body which recorded the running node."""
        node = torch._C._current_autograd_node()
        if node is None or not self.spans:
            return self.weight
        seq = node._sequence_nr()
        i = bisect.bisect_right(self.starts, seq) - 1
        if i >= 0 and seq < self.spans[i][1]:
            return self.weight * self.spans[i][2]
        return self.weight

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        kwargs = kwargs or {}
        inputs = _tensors((args, kwargs))
        for t in inputs:
            # a constant made by `torch.tensor` in a fake mode reaches it
            # real, to be lifted into a fake tensor
            if not isinstance(t, FakeTensor) and func not in _LIFTS:
                raise RuntimeError(
                    f"op_walk: {func} was given a real tensor "
                    f"{tuple(t.shape)}; a walk takes fake tensors only")
        weight = self._op_weight()
        before = self.flop_counter.get_total_flops()
        out = func(*args, **kwargs)
        self.cost.flops += weight * (
            self.flop_counter.get_total_flops() - before)
        outputs = _tensors(out)
        if func.is_view or not outputs:         # no data moved (metadata)
            return out
        moved = sum(map(_nbytes, inputs)) + sum(map(_nbytes, outputs))
        self.cost.bytes_ += weight * moved
        kind = _collective_kind(func)
        if kind is not None:
            self.cost.coll[kind] += weight * sum(map(_nbytes, inputs))
        seen = {id(t) for t in inputs}
        for t in outputs:
            if id(t) in seen:                   # in place: no new tensor
                continue
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live)
        return out

    @contextlib.contextmanager
    def weighted(self, n: int):
        outer, start = self.weight, _sequence_nr()
        self.weight = outer * n
        try:
            yield
        finally:
            self.weight = outer
            self.starts.append(start)
            self.spans.append((start, _sequence_nr(), n))


def analyze(fn, *args, **kwargs) -> CompCost:
    """The counts of `fn(*args, **kwargs)`, whose tensor arguments are fake
    tensors of one `FakeTensorMode`; call it inside that mode, so that
    tensors `fn` makes are fake too."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        walk = _OpWalk(counter)
        with weighing(walk), walk:
            fn(*args, **kwargs)
    return walk.cost
