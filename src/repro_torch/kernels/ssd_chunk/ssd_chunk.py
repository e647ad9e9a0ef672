"""Hand-written CUDA kernels: the Mamba2 SSD scan.

For every (batch, head) the (hd, N) state is carried through T tokens,
h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T and y_t = h_t C_t; the kernels
return (final_state, y).  They replace the TPU kernel
`src/repro/kernels/ssd_chunk/ssd_chunk.py:ssd_chunk_scan`.

Two designs (`csrc/ssd_chunk.cu`), chosen per call by `plan_ssd`:

- T <= `DECODE_T_MAX` (decode), bound by the state's bytes: the
  recurrence itself, each row of the state held in the registers of a few
  lanes, the tokens stepped in registers and the state read and written
  once, 16 bytes at a time where the state is 16-byte aligned.
- Longer T (prefill), bound by fp32 operations on CUDA cores and by bytes
  on the tensor cores: the SSD algorithm of the Mamba2 paper in three
  launches, every chunk of `CHUNK` tokens in parallel.  `ssd_chunk_state`
  takes each chunk's own end state and decay into a workspace;
  `ssd_chunk_pass` walks the chunks in order per state element, leaving
  each chunk's incoming state in the workspace and writing the final one;
  `ssd_chunk_out` takes y from the incoming state and the chunk's masked
  (L, L) intra-chunk term, with C B^T taken once per block and shared by
  its `heads` heads (B and C are per token).  Every product runs on the
  tensor cores in 3xTF32 (each fp32 operand split into two TF32 halves,
  three products), which keeps fp32 accuracy; on the H100 loading and
  splitting the operands, not the tensor cores, sets the pace, and the
  source note says what the design does about it.  Tiles are staged with
  `cp.async`, zero-filled past hd, N and a ragged last chunk.  The
  workspace, (B, H, T / L, hd, N) fp32 states and (B, H, T / L) decays, is
  allocated here with `torch.empty`: the kernels allocate nothing.  No
  atomics: two calls are bit-identical.

`launch=` (an "ssm" `kernels.tiles.Launch`) fixes the chunk kernels'
tokens per chunk, `chunk`; an illegal one raises ValueError.

`ssd_chunk_scan` launches the kernels for CUDA tensors and raises if it
cannot (where an operand requires grad, through `ScanWithGrad`, whose
backward differentiates the plain version); for CPU tensors it checks
`launch` and computes `ssd_chunk_scan_plain`, the chunked arithmetic in
plain PyTorch, with the launch's chunk.  `ssd_chunk_scan.launches`
counts calls that launched: one per call, whichever kernels it took.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from repro_torch.core.loops import counted_range
from repro_torch.kernels import build, tiles

#: tokens per chunk: the (L, L) intra-chunk tile is L = 64's 16 KB in fp32
#: (the TPU kernel's L = 256 would be 256 KB, over a block's 227 KB)
CHUNK = tiles.SSD_CHUNK

#: the most tokens the decode kernel steps; longer scans take the chunk
#: kernels
DECODE_T_MAX = tiles.SSD_DECODE_T_MAX

#: variants: the decode kernel with 16-byte or scalar state loads, and the
#: chunk kernels
DECODE_VECTOR, DECODE_SCALAR, CHUNKED = 0, 1, 2

#: threads of a decode block, and state values one lane holds of a row
DECODE_THREADS, LANE_ELEMS = 128, 8

#: dynamic shared memory a block may use without raising its limit
DEFAULT_SMEM = 48 * 1024

#: the chunk kernels' head groups, largest first: a state or out block
#: takes the largest that still gives every SM two blocks
HEAD_GROUPS = (tiles.SSD_MAX_HEADS, 2, 1)

#: threads of an `ssd_chunk_pass` block, and state elements each walks
PASS_THREADS, PASS_ELEMS = 256, 4

#: SMs of an H100 SXM: the grid the plan sizes for where no card is asked
SMS = 132


@dataclass(frozen=True)
class SsdPlan:
    """How one `ssd_chunk_scan` call is launched: the variant, `blocks`
    blocks of which each owns `rows` rows of one head's state (the decode
    kernel: `lanes` lanes per row), and `smem` bytes of dynamic shared
    memory (the chunk kernels: an out block's).  The chunk kernels also
    take chunks of `chunk` tokens, `heads` heads a state or out block, the
    state and out kernels' (chunks, head groups, batch) `grid` (`blocks`
    is its product), `pass_blocks` blocks of `ssd_chunk_pass`,
    `smem_state` bytes a state block, a `workspace` of that many bytes, and
    16-byte `cp.async` staging where `vec`."""
    variant: int
    lanes: int
    rows: int
    blocks: int
    chunk: int
    smem: int
    heads: int = 0
    grid: Tuple[int, int, int] = (0, 0, 0)
    pass_blocks: int = 0
    smem_state: int = 0
    workspace: int = 0
    vec: bool = False


#: shared memory of the chunk kernels' larger block
smem_bytes = tiles.ssd_smem_bytes


def decode_lanes(n: int) -> int:
    """Lanes that hold one state row in the decode kernel: the fewest (a
    power of two) that hold N values at LANE_ELEMS each."""
    return 1 << max(0, -(-n // LANE_ELEMS) - 1).bit_length()


def plan_ssd(b: int, t: int, h: int, hd: int, n: int, elt: int,
             ptrs: Sequence[int], chunk: int = None, *,
             stage_ptrs: Sequence[int] = (), sms: int = SMS) -> SsdPlan:
    """The launch of a scan of B x H heads of (hd, N) state over T tokens,
    elements of `elt` bytes; `ptrs`: the addresses of state0 and the final
    state.  T <= DECODE_T_MAX takes the decode kernel, where N fits 32 lanes'
    registers and the tokens' operands its shared memory: 16-byte state
    loads where every pointer and the row pitch N * elt are 16-byte
    aligned, scalar ones otherwise.  Longer T takes the chunk kernels
    (`plan_chunks`, with `chunk`, `stage_ptrs` and `sms`)."""
    lanes = decode_lanes(n)
    rows = DECODE_THREADS // lanes
    smem = 4 * t * (1 + 2 * n + rows)
    if t <= DECODE_T_MAX and lanes <= 32 and smem <= DEFAULT_SMEM:
        aligned = all(p % 16 == 0 for p in ptrs) and (n * elt) % 16 == 0
        return SsdPlan(DECODE_VECTOR if aligned else DECODE_SCALAR, lanes,
                       rows, b * h * -(-hd // rows), 0, smem)
    return plan_chunks(b, t, h, hd, n, elt, stage_ptrs, chunk, sms)


def plan_chunks(b: int, t: int, h: int, hd: int, n: int, elt: int,
                stage_ptrs: Sequence[int] = (), chunk: int = None,
                sms: int = SMS) -> SsdPlan:
    """The chunk kernels' launch for any T: chunks of `chunk` tokens (a
    validated launch's) or `CHUNK`; `heads` the largest of `HEAD_GROUPS`
    whose state and out grids give each of `sms` SMs two blocks (else 1);
    16-byte staging where x, B and C (`stage_ptrs`) are 16-byte aligned and
    hd and N whole 16-byte rows.  Raises where a chunk is longer than the
    kernels take or its blocks do not fit shared memory."""
    length = chunk or min(CHUNK, t)
    if length > tiles.SSD_MAX_CHUNK:
        raise ValueError(f"ssd_chunk_scan: chunk {length} is over the "
                         f"{tiles.SSD_MAX_CHUNK} tokens the chunk kernels "
                         f"take")
    nc = -(-t // length)
    heads = next((g for g in HEAD_GROUPS if nc * b * -(-h // g) >= 2 * sms),
                 1)
    heads = min(heads, h)
    groups = -(-h // heads)
    smem_state = tiles.ssd_state_smem(n, length, elt, heads)
    smem = tiles.ssd_out_smem(n, length, elt, heads)
    if max(smem, smem_state) > build.SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_scan: chunk {length} with N={n} needs "
                         f"{max(smem, smem_state)} B of shared memory, over "
                         f"the {build.SMEM_LIMIT} B a block may use")
    if b > 65535 or groups > 65535:
        raise ValueError(f"ssd_chunk_scan grid too large for B={b}, "
                         f"{groups} head groups")
    vec = (all(p % 16 == 0 for p in stage_ptrs) and (hd * elt) % 16 == 0
           and (n * elt) % 16 == 0)
    per = PASS_ELEMS if (hd * n) % PASS_ELEMS == 0 else 1
    return SsdPlan(CHUNKED, 0, min(hd, tiles.SSD_TILE_D), nc * groups * b,
                   length, smem, heads, (nc, groups, b),
                   -(-b * h * hd * n // (per * PASS_THREADS)), smem_state,
                   4 * b * h * nc * (hd * n + 1), vec)


def plan_call(x, b, c, dt, a, state0, sf, launch: tiles.Launch = None
              ) -> SsdPlan:
    """`plan_ssd` for these operands and the final state `sf`, at their
    actual addresses, for the card they lie on."""
    bsz, t, h, hd = x.shape
    sms = build.sm_count(x.device.index) if x.is_cuda else SMS
    return plan_ssd(bsz, t, h, hd, b.shape[-1], x.element_size(),
                    (state0.data_ptr(), sf.data_ptr()),
                    None if launch is None else launch.get("chunk"),
                    stage_ptrs=(x.data_ptr(), b.data_ptr(), c.data_ptr()),
                    sms=sms)


def _check(x, b, c, dt, a, state0, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_chunk_scan needs x (B, T, H, hd), got "
                         f"{tuple(x.shape)}")
    bsz, t, h, hd = x.shape
    n = b.shape[-1]
    want = {"b": (bsz, t, n), "c": (bsz, t, n), "dt": (bsz, t, h),
            "a": (h,), "state0": (bsz, h, hd, n)}
    got = {"b": b, "c": c, "dt": dt, "a": a, "state0": state0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssd_chunk_scan: {name} has shape "
                             f"{tuple(got[name].shape)}, want {shape}")
    if chunk < 1:
        raise ValueError(f"ssd_chunk_scan: chunk must be positive, got "
                         f"{chunk}")


def ssd_chunk_scan_plain(x, b, c, dt, a, state0, *, chunk: int = CHUNK
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunked arithmetic in plain PyTorch, in float32, each
    output rounded once to its input's dtype.  A ragged last chunk is
    shorter; `chunk` need not divide T."""
    _check(x, b, c, dt, a, state0, chunk)
    xf, bf, cf, dtf, af, h = (u.float() for u in (x, b, c, dt, a, state0))
    t = x.shape[1]
    ys = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    for t0 in _chunk_starts(t, chunk):
        sl = slice(t0, t0 + chunk)        # a slice stops at the tensor's end
        xc, bc, cc, dtc = xf[:, sl], bf[:, sl], cf[:, sl], dtf[:, sl]
        n = xc.shape[1]
        l = torch.cumsum(dtc * af, dim=1)                       # (B, L, H)
        # inter-chunk: exp(l_t) * C_t . h0
        y = torch.exp(l)[..., None] * torch.einsum("bln,bhdn->blhd", cc, h)
        # intra-chunk: W_tj = (C_t . B_j) exp(l_t - l_j), j <= t
        s_cb = torch.einsum("btn,bjn->btj", cc, bc)             # (B, L, L)
        ldiff = l[:, :, None, :] - l[:, None, :, :]             # (B,t,j,H)
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        # masked before the exp, not after: above the diagonal ldiff >= 0
        # can overflow, and a gradient through 0 x inf is NaN
        w = torch.exp(torch.where(causal, ldiff, -torch.inf)) \
            * s_cb[..., None]
        xdt = xc * dtc[..., None]                               # (B,L,H,hd)
        ys[:, sl] = y + torch.einsum("btjh,bjhd->bthd", w, xdt)
        # the state at the chunk's end
        decay_end = torch.exp(l[:, -1:] - l)                    # (B, L, H)
        h = torch.exp(l[:, -1])[..., None, None] * h + torch.einsum(
            "bjhd,bjn->bhdn", xdt * decay_end[..., None], bc)
    return h.to(state0.dtype), ys.to(x.dtype)


def _chunk_starts(t: int, chunk: int):
    """The first token of each chunk of T: the full chunks, then a ragged
    last one.  Each chunk writes its own rows of the output and carries
    only the state, so the full chunks walk through `counted_range`."""
    n_full = t // chunk
    for i in counted_range(n_full):
        yield i * chunk
    if t % chunk:
        yield n_full * chunk


@functools.lru_cache(maxsize=None)
def _launcher():
    return build.entry_point("ssd_chunk", "ssd_chunk_launch",
                             n_ptr=9, n_int=12)


def launch_uncounted(plan: SsdPlan, operands, y: torch.Tensor,
                     sf: torch.Tensor) -> None:
    """Launch `plan` on contiguous CUDA operands (x, b, c, dt, a, state0),
    writing y and sf, without adding to `ssd_chunk_scan.launches`: the
    wrapper's own launch, and a measurement's launch of a plan it chose
    itself (the chunk kernels at a decode T).  The chunk kernels get a
    workspace of `plan.workspace` bytes allocated here.  Raises if a launch
    is refused."""
    x, b = operands[0], operands[1]
    bsz, t, h, hd = x.shape
    code = build.dtype_code("ssd_chunk_scan", *operands, y, sf)
    ws = None
    if plan.variant == CHUNKED:
        ws = torch.empty(plan.workspace // 4, dtype=torch.float32,
                         device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.device.index, code, *(u.data_ptr() for u in operands),
                      y.data_ptr(), sf.data_ptr(),
                      None if ws is None else ws.data_ptr(), bsz, t, h, hd,
                      b.shape[-1], plan.variant, plan.lanes, plan.chunk,
                      plan.smem, plan.heads, plan.smem_state, int(plan.vec),
                      stream)
    if err:
        raise RuntimeError(f"ssd_chunk_scan launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, N {b.shape[-1]}, "
                           f"{plan})")


def ssd_chunk_scan(x, b, c, dt, a, state0, *, launch=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: the recurrence for T <= DECODE_T_MAX, else the chunk
    kernels over chunks of `CHUNK` tokens.  x: (B, T, H, hd); b/c:
    (B, T, N); dt: (B, T, H); a: (H,) negative; state0: (B, H, hd, N).
    Returns (final_state (B, H, hd, N), y (B, T, H, hd)) in the inputs'
    dtype.  `launch`: None (the planner's chunk), or an "ssm" `Launch` (or
    mapping) legal for this call."""
    _check(x, b, c, dt, a, state0, CHUNK)
    _, t, _, hd = x.shape
    launch = tiles.check_launch("ssm", launch,
                                {"t": t, "hd": hd, "n": b.shape[-1]})
    operands = (x, b, c, dt, a, state0)
    if all(u.device.type == "cpu" for u in operands):
        return ssd_chunk_scan_plain(*operands,
                                    chunk=launch.get("chunk") or CHUNK)
    build.require_contiguous("ssd_chunk_scan", x=x, b=b, c=c, dt=dt, a=a,
                             state0=state0)
    if torch.is_grad_enabled() and any(u.requires_grad for u in operands):
        sf, y = ScanWithGrad.apply(launch, launch.get("chunk") or CHUNK,
                                   *operands)
    else:
        sf, y = _launch(operands, launch)
    ssd_chunk_scan.launches += 1
    return sf, y


ssd_chunk_scan.launches = 0


def _launch(operands, launch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' (final_state, y) for contiguous CUDA operands."""
    y = torch.empty_like(operands[0])
    sf = torch.empty_like(operands[5])
    launch_uncounted(plan_call(*operands, sf, launch), operands, y, sf)
    return sf, y


class ScanWithGrad(torch.autograd.Function):
    """The kernels' forward with a gradient: `forward` launches them as a
    call without grad does (the same plan and outputs) and saves the six
    operands; `backward` recomputes `ssd_chunk_scan_plain` on them under
    autograd at the same chunk and returns its gradients.  The TPU kernel
    has no backward kernel either (the reference differentiates its plain
    chunked scan), so none is written here.  `ssd_chunk_scan` takes it
    only when an operand requires grad: serving and plans save nothing."""

    @staticmethod
    def forward(ctx, launch, chunk: int, *operands):
        ctx.chunk = chunk
        ctx.save_for_backward(*operands)
        return _launch(operands, launch)

    @staticmethod
    def backward(ctx, g_sf, g_y):
        inputs = [u.detach().requires_grad_(need) for u, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wanted = [u for u in inputs if u.requires_grad]
        with torch.enable_grad():
            sf, y = ssd_chunk_scan_plain(*inputs, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad((sf, y), wanted, (g_sf, g_y),
                                             allow_unused=True))
        return (None, None) + tuple(next(grads) if u.requires_grad else None
                                    for u in inputs)
