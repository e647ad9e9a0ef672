"""Plain PyTorch version of the prefill attention kernel: causal
self-attention in the arithmetic of `models.layers.attention_scores`
under a causal mask (the score product in q's dtype, scaled and
softmaxed in fp32, masked scores -1e30, the probabilities cast back to
q's dtype before the value product)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def prefill_attention_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, T, KV, hd), KV dividing H; query t
    attends to keys 0..t.  Scores are scaled by `scale`, 1 / sqrt(hd)
    unless given.  Returns (B, T, H, hd) in q's dtype."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).float()
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(b, t, h, hd)
