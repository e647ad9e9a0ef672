"""Two-group channel-split co-execution on PyTorch devices and streams.

The paper splits one operation's output channels across two heterogeneous
compute devices that share memory.  The JAX package maps the two devices
to two groups of a TPU mesh; the port maps them to two **groups**, each a
(torch device, stream) pair:

  * on a CUDA device, two `torch.cuda.Stream`s of that device — group 0
    ("fast", the GPU analogue) owns `c_fast` output channels, group 1
    ("slow", the CPU analogue) owns `C_out - c_fast`, and the two sides'
    kernels are queued on their own streams so they can overlap;
  * on the CPU, two groups that run one after the other (every split is
    testable without a card);
  * with a single group, nothing is split and every node runs exclusive.

A split op leaves a `GroupLocal` result: each group's own (..., c_g)
part plus the event its stream recorded after writing it.  When the
consumer is split too (the paper's "subsequent CPU and GPU operations
read the shared output directly"), `gather=False` keeps the result
group-local and the consumer takes it via `x_plan=`: each consumer group
waits on the producer's events *on its own stream* and rebuilds its input
there — no host synchronization, the analogue of the reference's
in-program all-gather.  `gather_stacked` is the paper's sync point: the
caller's stream waits on both events and concatenates.  A kv-block split
of decode attention is not stackable: each side attends over its own
block of cache positions, and `gather_lse` merges the two sides' softmax
partials at the same kind of sync point.

A tensor written on one stream and read on another is marked with
`Tensor.record_stream` for the reading stream, so PyTorch's caching
allocator cannot hand its memory out again before that stream is past it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.types import ConvOp
from repro_torch.kernels.split_matmul.split_matmul import split_matmul
from repro_torch.kernels.winograd_conv.ops import conv2d_op, crop_to_declared


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Uneven output-channel split across two groups."""

    c_out: int
    c_fast: int                  # channels owned by group 0
    align: int = 8               # channel alignment granularity

    @property
    def c_slow(self) -> int:
        return self.c_out - self.c_fast

    @property
    def c_pad(self) -> int:
        """Uniform padded width of the packed weight stack: max of the
        two shares, aligned."""
        a = self.align
        return -(-max(self.c_fast, self.c_slow) // a) * a

    def width(self, group: int) -> int:
        return self.c_fast if group == 0 else self.c_slow


def throughput_split(c_out: int, fast_share: float,
                     align: int = 8) -> SplitPlan:
    """Balance channels proportionally to group throughputs (the closed-form
    optimum of the paper's objective for linear cost models): the fast
    group's share rounded to the alignment, clamped to 0..c_out."""
    c_fast = int(round(c_out * fast_share / align)) * align
    c_fast = min(max(c_fast, 0), c_out)
    return SplitPlan(c_out=c_out, c_fast=c_fast, align=align)


def split_for_groups(c_out: int, c_fast: int, groups: Sequence["Group"],
                     align: int = 8) -> SplitPlan:
    """A partitioner decision (c_gpu channels on the fast group) lowered
    onto concrete groups.  The reference lifts the alignment to
    lcm(align, lanes) of its mesh; a group here is one lane, so the
    alignment stays `align`."""
    if len(groups) != 2:
        raise ValueError(f"a channel split needs 2 groups, got {len(groups)}")
    if not 0 <= c_fast <= c_out:
        raise ValueError(f"split {c_fast} out of range 0..{c_out}")
    return SplitPlan(c_out=c_out, c_fast=c_fast, align=align)


# ----------------------------------------------------------------- groups

def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller
    asks for another device.  Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Group:
    """One co-execution group: a device and, on CUDA, the stream its work
    is queued on (None on the CPU, where groups run in program order)."""

    device: torch.device
    stream: Optional[torch.cuda.Stream] = None

    def scope(self):
        """Make this group's stream current (no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def record(self) -> Optional[torch.cuda.Event]:
        """An event marking everything queued on this group so far."""
        if self.stream is None:
            return None
        return self.stream.record_event()


def coexec_groups(device: Union[str, torch.device, None] = None, *,
                  n: int = 2) -> Tuple[Group, ...]:
    """`n` co-execution groups on `device` (1 = the degraded exclusive-only
    configuration, 2 = split-capable)."""
    if n not in (1, 2):
        raise ValueError(f"co-execution uses 1 or 2 groups, got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(Group(dev, torch.cuda.Stream(dev)) for _ in range(n))
    return tuple(Group(dev) for _ in range(n))


# ------------------------------------------------------------- activations

@dataclasses.dataclass
class GroupLocal:
    """A split op's output that has NOT been gathered: group g's part holds
    its `split.width(g)` channels, `events[g]` marks its completion on the
    group's stream (None on the CPU).  `shape` is the logical shape the
    parts concatenate to."""

    parts: Tuple[torch.Tensor, torch.Tensor]
    events: Tuple[Optional[torch.cuda.Event], Optional[torch.cuda.Event]]
    split: SplitPlan

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.parts[0].shape[:-1]) + (self.split.c_out,)


def _hand_over(t: torch.Tensor, event: Optional[torch.cuda.Event],
               stream: Optional[torch.cuda.Stream]) -> None:
    """Make `stream` wait for `t` (written before `event`) and keep `t`'s
    memory allocated until `stream` is past its reads.  Legal inside a CUDA
    graph capture too: the allocator defers the end-of-use events until
    the capture ends."""
    if stream is None:
        return
    if event is not None:
        stream.wait_event(event)
    t.record_stream(stream)


def gather_stacked(y: GroupLocal) -> torch.Tensor:
    """Materialize the combined output of a group-local result — the
    paper's synchronization point — on the caller's current stream."""
    dev = y.parts[0].device
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    for part, ev in zip(y.parts, y.events):
        _hand_over(part, ev, stream)
    return torch.cat(y.parts, dim=-1)


def pack_weights(w: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """(..., C_out) -> (2, ..., c_pad): per-group zero-padded weight
    slices over the trailing output-channel dim (the reference's layout;
    group g reads `packed[g][..., :plan.width(g)]`)."""
    lead = tuple(w.shape[:-1])
    packed = torch.zeros((2,) + lead + (plan.c_pad,), dtype=w.dtype,
                         device=w.device)
    packed[0, ..., :plan.c_fast] = w[..., :plan.c_fast]
    packed[1, ..., :plan.c_slow] = w[..., plan.c_fast:]
    return packed


_Input = Union[torch.Tensor, GroupLocal]


def run_sides(x: _Input, groups: Sequence[Group],
              x_plan: Optional[SplitPlan],
              side: Callable[[int, torch.Tensor], Any]
              ) -> Tuple[list, list]:
    """Run `side(g, x_full)` for both groups, each on its own stream;
    returns the sides' results and the events marking their completion."""
    if len(groups) != 2:
        raise ValueError(f"a channel split needs 2 groups, got {len(groups)}")
    chained = x_plan is not None
    if chained != isinstance(x, GroupLocal):
        raise TypeError("pass x_plan= exactly when x is a producer's "
                        "group-local result")
    if chained and x.split != x_plan:
        raise ValueError(f"x_plan {x_plan} does not describe the input "
                         f"split {x.split}")
    caller = (torch.cuda.current_stream(groups[0].device)
              if groups[0].stream is not None else None)
    parts, events = [], []
    for g, grp in enumerate(groups):
        with grp.scope():
            if chained:
                for part, ev in zip(x.parts, x.events):
                    _hand_over(part, ev, grp.stream)
                x_full = torch.cat(x.parts, dim=-1)
            else:
                if grp.stream is not None:
                    grp.stream.wait_stream(caller)
                    x.record_stream(grp.stream)
                x_full = x
            parts.append(side(g, x_full))
            events.append(grp.record())
    return parts, events


def split_run(x: _Input, plan: SplitPlan, groups: Sequence[Group],
              x_plan: Optional[SplitPlan],
              side: Callable[[int, torch.Tensor], torch.Tensor],
              gather: bool) -> Union[torch.Tensor, GroupLocal]:
    """Run `side(g, x_full)` for both groups on their own streams, each
    producing its `plan.width(g)` output channels: the channel splits and
    the typed stackable axes (head, ssm-state), whose plans count channels
    (`c_fast = n_fast * hd`)."""
    parts, events = run_sides(x, groups, x_plan, side)
    out = GroupLocal(tuple(parts), tuple(events), plan)
    return gather_stacked(out) if gather else out


def gather_lse(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               events: Sequence[Optional[torch.cuda.Event]]) -> torch.Tensor:
    """The sync point of a kv-block split: the caller's stream waits on
    both sides' events, then merges their softmax partials.  Side g gives
    its normalized output o_g (H, hd) over its block of cache positions and
    the log-sum-exp lse_g (H,) of its scores; the whole cache's output is
    sum_g exp(lse_g - M) o_g / sum_g exp(lse_g - M), M = max_g lse_g."""
    dev = parts[0][0].device
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    for part, ev in zip(parts, events):
        for t in part:
            _hand_over(t, ev, stream)
    (o0, lse0), (o1, lse1) = parts
    lse = torch.stack([lse0, lse1])                         # (2, H)
    w = torch.exp(lse - lse.max(dim=0).values)              # (2, H)
    num = w[0][:, None] * o0.float() + w[1][:, None] * o1.float()
    return (num / (w[0] + w[1])[:, None]).to(o0.dtype)


def coexec_matmul(x: _Input, packed_w: torch.Tensor, plan: SplitPlan,
                  groups: Sequence[Group], *, gather: bool = True,
                  x_plan: Optional[SplitPlan] = None
                  ) -> Union[torch.Tensor, GroupLocal]:
    """Channel-split matmul: each group computes its slice of X @ W with
    one `split_matmul` launch on its own stream.

    x: (L, C_in) — or, with `x_plan`, the producer's `GroupLocal`.
    packed_w: (2, C_in, c_pad) from `pack_weights`.
    Returns (L, C_out) if gather else the `GroupLocal` result.
    """
    def side(g: int, x_full: torch.Tensor) -> torch.Tensor:
        if plan.width(g) == 0:          # an exclusive split: nothing here
            return x_full.new_empty(tuple(x_full.shape[:-1]) + (0,))
        return split_matmul(x_full.contiguous(), packed_w[g], 0,
                            plan.width(g))

    return split_run(x, plan, groups, x_plan, side, gather)


def coexec_conv2d(x: _Input, packed_w: torch.Tensor, plan: SplitPlan,
                  groups: Sequence[Group], *, op: ConvOp,
                  gather: bool = True, x_plan: Optional[SplitPlan] = None
                  ) -> Union[torch.Tensor, GroupLocal]:
    """Channel-split SAME convolution of the node `op` across the groups.

    x: (B, H, W, C_in) — or, with `x_plan`, the producer's `GroupLocal`.
    packed_w: (2, K, K, C_in, c_pad) from `pack_weights`.  Both sides take
    the algorithm `op` selects (Winograd when the declared op passes the
    gate, direct otherwise), and outputs are cropped to the declared
    (floor) shape so chained nodes see exactly the planned activation.
    Returns (B, H_out, W_out, C_out) if gather else the `GroupLocal`.
    """
    def side(g: int, x_full: torch.Tensor) -> torch.Tensor:
        if plan.width(g) == 0:          # an exclusive split: nothing here
            return x_full.new_empty((x_full.shape[0], op.H_out, op.W_out, 0))
        w_g = packed_w[g][..., :plan.width(g)]
        return crop_to_declared(conv2d_op(x_full, w_g, op), op)

    return split_run(x, plan, groups, x_plan, side, gather)
