"""Hand-written CUDA kernel: the chunked Mamba2 SSD scan.

For every (batch, head) the (hd, N) state is carried through T tokens,
h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T and y_t = h_t C_t; the kernel
returns (final_state, y).  It replaces the TPU kernel
`src/repro/kernels/ssd_chunk/ssd_chunk.py:ssd_chunk_scan`.

Bound on an H100: at decode (T = 1) the bytes of the state read and
written once; in chunked prefill, fp32 operations.  Design
(`csrc/ssd_chunk.cu`): one block per (batch, head) runs the chunk loop in
order with the state in shared memory; each chunk of `CHUNK` tokens takes
the inter-chunk term, the masked (L, L) intra-chunk term and the state
update of the TPU kernel.

`ssd_chunk_scan` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes `ssd_chunk_scan_plain`, the same
chunked arithmetic in plain PyTorch.  `ssd_chunk_scan.launches` counts
launches.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

#: tokens per chunk: the (L, L) tile and the chunk's x, B and C sit in
#: shared memory beside the state (the TPU kernel's L = 256 would not fit)
CHUNK = 64

#: shared memory one Hopper block may use, in bytes
SMEM_LIMIT = 232448


def smem_bytes(hd: int, n: int, chunk: int) -> int:
    """Shared memory of one block: the (hd, N+1) state, (L, hd) x * dt,
    (L, N+1) B and C, the (L, L) tile and four (L,) vectors, in fp32."""
    return 4 * (hd * (n + 1) + chunk * hd + 2 * chunk * (n + 1)
                + chunk * chunk + 4 * chunk)


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
                             n_ptr=8, n_int=7)


def ssd_chunk_scan(x, b, c, dt, a, state0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in chunks of `CHUNK` tokens.  x: (B, T, H, hd);
    b/c: (B, T, N); dt: (B, T, H); a: (H,) negative; state0: (B, H, hd, N).
    Returns (final_state (B, H, hd, N), y (B, T, H, hd)) in the inputs'
    dtype."""
    _check(x, b, c, dt, a, state0, CHUNK)
    operands = (x, b, c, dt, a, state0)
    if all(u.device.type == "cpu" for u in operands):
        return ssd_chunk_scan_plain(*operands)
    code = build.dtype_code("ssd_chunk_scan", *operands)
    bsz, t, h, hd = x.shape
    n = b.shape[-1]
    length = min(CHUNK, t)
    smem = smem_bytes(hd, n, length)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_scan: chunk {length} with hd={hd}, "
                         f"N={n} needs {smem} B of shared memory, over the "
                         f"{SMEM_LIMIT} B a block may use")
    if bsz > 65535:
        raise ValueError(f"ssd_chunk_scan grid too large for B={bsz}")
    y = torch.empty_like(x)
    sf = torch.empty_like(state0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.device.index, code, *(u.data_ptr() for u in operands),
                      y.data_ptr(), sf.data_ptr(), bsz, t, h, hd, n, length,
                      smem, stream)
    if err:
        raise RuntimeError(f"ssd_chunk_scan launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, N {n}, chunk "
                           f"{length})")
    ssd_chunk_scan.launches += 1
    return sf, y


ssd_chunk_scan.launches = 0
