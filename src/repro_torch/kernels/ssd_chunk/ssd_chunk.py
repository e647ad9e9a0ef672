"""Hand-written CUDA kernel: the Mamba2 SSD scan.

For every (batch, head) the (hd, N) state is carried through T tokens,
h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T and y_t = h_t C_t; the kernel
returns (final_state, y).  It replaces the TPU kernel
`src/repro/kernels/ssd_chunk/ssd_chunk.py:ssd_chunk_scan`.

Bound on an H100: at decode (T = 1) the bytes of the state read and
written once; in chunked prefill, fp32 operations.  Design
(`csrc/ssd_chunk.cu`), two kernels chosen per call by `plan_ssd`:

- T <= `DECODE_T_MAX` (decode): the recurrence itself, with each row of the
  state held in the registers of a few lanes, the tokens stepped in
  registers and the state read and written once, 16 bytes at a time where
  the state is 16-byte aligned.
- Longer T (prefill): one block per (batch, head) runs the chunk loop in
  order with the state in shared memory; each chunk of `CHUNK` tokens takes
  the inter-chunk term, the masked (L, L) intra-chunk term and the state
  update of the TPU kernel.

`ssd_chunk_scan` launches a kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes `ssd_chunk_scan_plain`, the chunked
arithmetic in plain PyTorch.  `ssd_chunk_scan.launches` counts launches.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

#: tokens per chunk: the (L, L) tile and the chunk's x, B and C sit in
#: shared memory beside the state (the TPU kernel's L = 256 would not fit)
CHUNK = 64

#: the most tokens the decode kernel steps; longer scans take the chunk
#: kernel
DECODE_T_MAX = 16

#: variants: the decode kernel with 16-byte or scalar state loads, and the
#: chunk kernel
DECODE_VECTOR, DECODE_SCALAR, CHUNKED = 0, 1, 2

#: threads of a decode block, and state values one lane holds of a row
DECODE_THREADS, LANE_ELEMS = 128, 8

#: dynamic shared memory a block may use without raising its limit
DEFAULT_SMEM = 48 * 1024


@dataclass(frozen=True)
class SsdPlan:
    """How one `ssd_chunk_scan` call is launched: the variant, `blocks`
    blocks of which each owns `rows` rows of one head's state (the decode
    kernel: `lanes` lanes per row; the chunk kernel: all hd rows, chunks of
    `chunk` tokens), and `smem` bytes of dynamic shared memory."""
    variant: int
    lanes: int
    rows: int
    blocks: int
    chunk: int
    smem: int


def smem_bytes(hd: int, n: int, chunk: int) -> int:
    """Shared memory of one block: the (hd, N+1) state, (L, hd) x * dt,
    (L, N+1) B and C, the (L, L) tile and four (L,) vectors, in fp32."""
    return 4 * (hd * (n + 1) + chunk * hd + 2 * chunk * (n + 1)
                + chunk * chunk + 4 * chunk)


def decode_lanes(n: int) -> int:
    """Lanes that hold one state row in the decode kernel: the fewest (a
    power of two) that hold N values at LANE_ELEMS each."""
    return 1 << max(0, -(-n // LANE_ELEMS) - 1).bit_length()


def plan_ssd(b: int, t: int, h: int, hd: int, n: int, elt: int,
             ptrs: Sequence[int]) -> SsdPlan:
    """The launch of a scan of B x H heads of (hd, N) state over T tokens,
    elements of `elt` bytes; `ptrs`: the addresses of state0 and the final
    state.  T <= DECODE_T_MAX takes the decode kernel, where N fits 32 lanes'
    registers and the tokens' operands its shared memory: 16-byte state
    loads where every pointer and the row pitch N * elt are 16-byte
    aligned, scalar ones otherwise.  Longer T takes the chunk kernel;
    raises where its chunk does not fit a block's shared memory."""
    lanes = decode_lanes(n)
    rows = DECODE_THREADS // lanes
    smem = 4 * t * (1 + 2 * n + rows)
    if t <= DECODE_T_MAX and lanes <= 32 and smem <= DEFAULT_SMEM:
        aligned = all(p % 16 == 0 for p in ptrs) and (n * elt) % 16 == 0
        return SsdPlan(DECODE_VECTOR if aligned else DECODE_SCALAR, lanes,
                       rows, b * h * -(-hd // rows), 0, smem)
    length = min(CHUNK, t)
    smem = smem_bytes(hd, n, length)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_scan: chunk {length} with hd={hd}, "
                         f"N={n} needs {smem} B of shared memory, over the "
                         f"{build.SMEM_LIMIT} B a block may use")
    if b > 65535:
        raise ValueError(f"ssd_chunk_scan grid too large for B={b}")
    return SsdPlan(CHUNKED, 0, hd, b * h, length, smem)


def plan_call(x, b, c, dt, a, state0, sf) -> SsdPlan:
    """`plan_ssd` for these operands and the final state `sf`, at their
    actual addresses."""
    bsz, t, h, hd = x.shape
    return plan_ssd(bsz, t, h, hd, b.shape[-1], x.element_size(),
                    (state0.data_ptr(), sf.data_ptr()))


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
    ys = []
    for t0 in range(0, t, chunk):
        sl = slice(t0, min(t, t0 + chunk))
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
        w = torch.where(causal, torch.exp(ldiff) * s_cb[..., None],
                        torch.zeros((), device=x.device))
        xdt = xc * dtc[..., None]                               # (B,L,H,hd)
        ys.append(y + torch.einsum("btjh,bjhd->bthd", w, xdt))
        # the state at the chunk's end
        decay_end = torch.exp(l[:, -1:] - l)                    # (B, L, H)
        h = torch.exp(l[:, -1])[..., None, None] * h + torch.einsum(
            "bjhd,bjn->bhdn", xdt * decay_end[..., None], bc)
    return h.to(state0.dtype), torch.cat(ys, dim=1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    return build.entry_point("ssd_chunk", "ssd_chunk_launch",
                             n_ptr=8, n_int=9)


def launch_uncounted(plan: SsdPlan, operands, y: torch.Tensor,
                     sf: torch.Tensor) -> None:
    """Launch `plan` on contiguous CUDA operands (x, b, c, dt, a, state0),
    writing y and sf, without adding to `ssd_chunk_scan.launches`: the
    wrapper's own launch, and a measurement's launch of a plan it chose
    itself (the chunk kernel at a decode T).  Raises if the launch is
    refused."""
    x, b = operands[0], operands[1]
    bsz, t, h, hd = x.shape
    code = build.dtype_code("ssd_chunk_scan", *operands, y, sf)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.device.index, code, *(u.data_ptr() for u in operands),
                      y.data_ptr(), sf.data_ptr(), bsz, t, h, hd,
                      b.shape[-1], plan.variant, plan.lanes, plan.chunk,
                      plan.smem, stream)
    if err:
        raise RuntimeError(f"ssd_chunk_scan launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, N {b.shape[-1]}, "
                           f"{plan})")


def ssd_chunk_scan(x, b, c, dt, a, state0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: the recurrence for T <= DECODE_T_MAX, else chunks of
    `CHUNK` tokens.  x: (B, T, H, hd); b/c: (B, T, N); dt: (B, T, H); a:
    (H,) negative; state0: (B, H, hd, N).  Returns (final_state
    (B, H, hd, N), y (B, T, H, hd)) in the inputs' dtype."""
    _check(x, b, c, dt, a, state0, CHUNK)
    operands = (x, b, c, dt, a, state0)
    if all(u.device.type == "cpu" for u in operands):
        return ssd_chunk_scan_plain(*operands)
    build.require_contiguous("ssd_chunk_scan", x=x, b=b, c=c, dt=dt, a=a,
                             state0=state0)
    y = torch.empty_like(x)
    sf = torch.empty_like(state0)
    launch_uncounted(plan_call(*operands, sf), operands, y, sf)
    ssd_chunk_scan.launches += 1
    return sf, y


ssd_chunk_scan.launches = 0
