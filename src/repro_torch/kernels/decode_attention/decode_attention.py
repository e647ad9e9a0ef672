"""Hand-written CUDA kernel: single-token decode attention over a KV cache.

One query token of H heads attends to S cached positions of KV heads (GQA:
the g = H / KV query heads of one KV head share its K and V rows), with a
positional causal mask and an optional sliding window.  It replaces the TPU
kernel `src/repro/kernels/decode_attention/decode_attention.py:
decode_attention`, and returns beside the normalized output each head's
log-sum-exp, which a kv-block split merges across its two groups.

Bound on an H100: K and V are read once, so it is bound by their bytes
(the zamba2-7b node's fp32 cache is 117 MB).  Design
(`csrc/decode_attention.cu`): the attended positions lo..hi are cut into
`nsplit` runs of whole `TILE`-position tiles per KV head, one block per
(KV head, run), the grid one wave of the blocks the card holds at once.
Each block streams its run through a `STAGES`-deep ring of K and V tiles in
shared memory (16-byte `cp.async` copies, or scalar copies where the
operands are not 16-byte aligned) and keeps an online softmax across its
tiles; a second pass merges the runs' partials in a fixed order, so two
calls on the same inputs give bit-identical results.  `plan_attention` is
the host half of that design; `launch=` (an "attention"
`kernels.tiles.Launch`) fixes the tiles per run, `run_tiles`, instead,
and an illegal one raises ValueError.

`decode_attention` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes `decode_attention_plain`, the same
function in plain PyTorch.  `decode_attention.launches` counts launches.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.kernels import build, tiles

#: variants of pass 1: 16-byte `cp.async` copies of K and V, or scalar ones
VECTOR, SCALAR = 0, 1
#: cache positions per tile, tiles in the ring, threads per pass-1 block
TILE, STAGES, THREADS = tiles.ATTN_TILE, 3, 256
#: the most (query head, 16-byte chunk of hd) pairs a block accumulates:
#: four per thread
MAX_ITEMS = 4 * THREADS


@dataclass(frozen=True)
class AttnPlan:
    """How one `decode_attention` call is launched: the attended positions
    lo..hi, cut into `nsplit` runs of `run_tiles` tiles each (the last run
    may be shorter) for every one of the `kv` KV heads; `chunks` 16-byte
    chunks per row of hd, padded; `smem` bytes of dynamic shared memory per
    pass-1 block."""
    variant: int
    lo: int
    hi: int
    kv: int
    run_tiles: int
    nsplit: int
    chunks: int
    smem: int
    tile: int = TILE
    stages: int = STAGES

    @property
    def run_len(self) -> int:
        return self.run_tiles * self.tile

    @property
    def blocks(self) -> int:
        return self.kv * self.nsplit

    def runs(self) -> List[Tuple[int, int]]:
        """The (first, last + 1) positions of each run."""
        return [(self.lo + r * self.run_len,
                 min(self.hi + 1, self.lo + (r + 1) * self.run_len))
                for r in range(self.nsplit)]


def valid_range(s: int, pos: int, window: int) -> Tuple[int, int]:
    """The attended positions lo..hi: k_pos <= pos, and k_pos > pos - window
    when window > 0.  Raises where no position is attended."""
    lo = max(0, pos - window + 1) if window > 0 else 0
    hi = min(s - 1, pos)
    if lo > hi:
        raise ValueError(f"decode attention at pos {pos} (window {window}) "
                         f"attends to none of the {s} cached positions")
    return lo, hi


def attn_variant(kv: int, hd: int, elt: int, k_ptr: int, v_ptr: int) -> int:
    """VECTOR where K's and V's data, the row pitch KV * hd * elt and a
    head's hd * elt bytes are all 16-byte aligned, SCALAR otherwise."""
    aligned = (k_ptr % 16 == 0 and v_ptr % 16 == 0
               and (kv * hd * elt) % 16 == 0 and (hd * elt) % 16 == 0)
    return VECTOR if aligned else SCALAR


def attn_smem(g: int, hd: int, elt: int) -> int:
    """Shared memory of one pass-1 block: the ring of K and V tiles (rows
    padded to whole 16-byte chunks; after the run it holds the threads'
    fp32 partial sums, 16 elements' worth per thread at most), then the g
    query rows and tile scores in fp32 and (max, sum, rescale) per head."""
    chunks = -(-hd * elt // 16)
    ring = STAGES * 2 * TILE * chunks * 16
    padded = chunks * 16 // elt
    return max(ring, THREADS * 16 // elt * 4) + 4 * g * (padded + TILE + 3)


def plan_attention(lo: int, hi: int, kv: int, g: int, hd: int, elt: int,
                   k_ptr: int, v_ptr: int, resident: int,
                   run_tiles: int = None) -> AttnPlan:
    """The launch of attention over positions lo..hi of a cache with `kv`
    KV heads of `g` query heads each, hd elements of `elt` bytes, K's and
    V's data at `k_ptr` and `v_ptr`, on a card that holds `resident`
    pass-1 blocks at once (SMs x blocks per SM).  The positions are cut
    into runs of whole tiles so that kv x nsplit is at most one wave of
    `resident` blocks and no run is empty; a validated `run_tiles` fixes
    the tiles per run instead.  Raises where a block's query heads or
    shared memory exceed what the kernel takes."""
    if not 0 <= lo <= hi or min(kv, g, hd, resident) < 1:
        raise ValueError(f"decode_attention plan: nothing to attend (lo "
                         f"{lo}, hi {hi}, kv {kv}, g {g}, hd {hd}, resident "
                         f"{resident})")
    chunks = -(-hd * elt // 16)
    if g * chunks > MAX_ITEMS:
        raise ValueError(f"decode_attention: {g} query heads per KV head at "
                         f"hd={hd} are over the {MAX_ITEMS} 16-byte chunks "
                         f"a block accumulates")
    smem = attn_smem(g, hd, elt)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"decode_attention: g={g}, hd={hd} needs {smem} B "
                         f"of shared memory, over the {build.SMEM_LIMIT} B a "
                         f"block may use")
    n_tiles = -(-(hi - lo + 1) // TILE)
    if run_tiles is None:
        run_tiles = -(-n_tiles // min(n_tiles, max(1, resident // kv)))
    return AttnPlan(attn_variant(kv, hd, elt, k_ptr, v_ptr), lo, hi, kv,
                    run_tiles, -(-n_tiles // run_tiles), chunks, smem)


def resident_blocks(device_index: int, code: int, variant: int,
                    smem: int) -> int:
    """Pass-1 blocks of this instantiation one SM holds at once with `smem`
    bytes of shared memory."""
    return build.resident_blocks("decode_attention",
                                 "decode_attention_resident", device_index,
                                 code, variant, smem)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 2 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[2] != q.shape[1] or q.shape[0] % k.shape[1]:
        raise ValueError(f"decode_attention needs q (H, hd) and k, v "
                         f"(S, KV, hd) with KV dividing H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def plan_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
              window: int = 0, launch: tiles.Launch = None) -> AttnPlan:
    """`plan_attention` for these CUDA operands: K's and V's actual
    addresses, the device's SMs and the instantiation's resident blocks."""
    h, hd = q.shape
    s, kv, _ = k.shape
    lo, hi = valid_range(s, pos, window)
    elt = k.element_size()
    dev = k.device.index
    code = build.dtype_code("decode_attention", q, k, v)
    per_sm = resident_blocks(dev, code,
                             attn_variant(kv, hd, elt, k.data_ptr(),
                                          v.data_ptr()),
                             attn_smem(h // kv, hd, elt))
    return plan_attention(lo, hi, kv, h // kv, hd, elt, k.data_ptr(),
                          v.data_ptr(), per_sm * build.sm_count(dev),
                          None if launch is None
                          else launch.get("run_tiles"))


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pos: int, *, window: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (out (H, hd) in q's dtype,
    lse (H,) float32), computed in float32."""
    h, hd = q.shape
    s, kv, _ = k.shape
    lo, hi = valid_range(s, pos, window)
    qg = q.reshape(kv, h // kv, hd).float()
    scores = torch.einsum("hgd,hsd->hgs", qg,
                          k.transpose(0, 1).float()) / math.sqrt(hd)
    k_pos = torch.arange(s, device=q.device)
    mask = (k_pos >= lo) & (k_pos <= hi)
    scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                   # (kv, g)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("hgs,hsd->hgd", probs, v.transpose(0, 1).float())
    return out.reshape(h, hd).to(q.dtype), lse.reshape(h)


@functools.lru_cache(maxsize=None)
def _launcher():
    return build.entry_point("decode_attention", "decode_attention_launch",
                             n_ptr=8, n_int=11)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, *, window: int = 0, launch=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (H, hd); k/v: (S, KV, hd); pos: the query's position.  Returns
    (out (H, hd) in q's dtype, lse (H,) float32).  `launch`: None (the
    planner's runs), or an "attention" `Launch` (or mapping) legal for this
    call."""
    _check_shapes(q, k, v)
    h, hd = q.shape
    lo, hi = valid_range(k.shape[0], pos, window)
    launch = tiles.check_launch("attention", launch,
                                {"tiles": -(-(hi - lo + 1) // TILE)})
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return decode_attention_plain(q, k, v, pos, window=window)
    build.require_contiguous("decode_attention", q=q, k=k, v=v)
    code = build.dtype_code("decode_attention", q, k, v)
    plan = plan_call(q, k, v, pos, window, launch)
    dev = q.device
    out = torch.empty((h, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((h,), dtype=torch.float32, device=dev)
    m_part = torch.empty((h, plan.nsplit), dtype=torch.float32, device=dev)
    l_part = torch.empty((h, plan.nsplit), dtype=torch.float32, device=dev)
    acc_part = torch.empty((h, plan.nsplit, hd), dtype=torch.float32,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(dev.index, code, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      m_part.data_ptr(), l_part.data_ptr(),
                      acc_part.data_ptr(), h, plan.kv, hd, plan.lo, plan.hi,
                      plan.variant, plan.run_len, plan.nsplit, plan.chunks,
                      plan.smem, plan.tile, stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"pos {pos}, window {window}, {plan})")
    decode_attention.launches += 1
    return out, lse


decode_attention.launches = 0
