"""Hand-written CUDA kernel: single-token decode attention over a KV cache.

One query token of H heads attends to S cached positions of KV heads (GQA:
the g = H / KV query heads of one KV head share its K and V rows), with a
positional causal mask and an optional sliding window.  It replaces the TPU
kernel `src/repro/kernels/decode_attention/decode_attention.py:
decode_attention`, and returns beside the normalized output each head's
log-sum-exp, which a kv-block split merges across its two groups.

Bound on an H100: K and V are read once, so it is bound by their bytes
(the zamba2-7b node's fp32 cache is 117 MB).  Design
(`csrc/decode_attention.cu`): pass 1 runs one block per (KV head, block of
`BLOCK_S` positions) and writes softmax partials; pass 2 merges them per
query head by log-sum-exp.

`decode_attention` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes `decode_attention_plain`, the same
function in plain PyTorch.  `decode_attention.launches` counts launches.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

#: cache positions per pass-1 block
BLOCK_S = 64


def valid_range(s: int, pos: int, window: int) -> Tuple[int, int]:
    """The attended positions lo..hi: k_pos <= pos, and k_pos > pos - window
    when window > 0.  Raises where no position is attended."""
    lo = max(0, pos - window + 1) if window > 0 else 0
    hi = min(s - 1, pos)
    if lo > hi:
        raise ValueError(f"decode attention at pos {pos} (window {window}) "
                         f"attends to none of the {s} cached positions")
    return lo, hi


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
                             n_ptr=8, n_int=7)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, *, window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (H, hd); k/v: (S, KV, hd); pos: the query's position.  Returns
    (out (H, hd) in q's dtype, lse (H,) float32)."""
    if q.dim() != 2 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[2] != q.shape[1] or q.shape[0] % k.shape[1]:
        raise ValueError(f"decode_attention needs q (H, hd) and k, v "
                         f"(S, KV, hd) with KV dividing H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    h, hd = q.shape
    s, kv, _ = k.shape
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return decode_attention_plain(q, k, v, pos, window=window)
    code = build.dtype_code("decode_attention", q, k, v)
    lo, hi = valid_range(s, pos, window)
    nsb = -(-s // BLOCK_S)
    if nsb > 65535:
        raise ValueError(f"decode_attention grid too large for S={s}")
    dev = q.device
    out = torch.empty((h, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((h,), dtype=torch.float32, device=dev)
    m_part = torch.empty((h, nsb), dtype=torch.float32, device=dev)
    l_part = torch.empty((h, nsb), dtype=torch.float32, device=dev)
    acc_part = torch.empty((h, nsb, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(dev.index, code, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      m_part.data_ptr(), l_part.data_ptr(),
                      acc_part.data_ptr(), h, s, kv, hd, BLOCK_S, lo, hi,
                      stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"pos {pos}, window {window})")
    decode_attention.launches += 1
    return out, lse


decode_attention.launches = 0
