"""Plain PyTorch oracle for decode attention (GQA, causal, optional
window): the port's copy of `repro.kernels.decode_attention.ref`."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int, *, window: int = 0) -> torch.Tensor:
    """q: (H, hd); k/v: (S, kv, hd); pos scalar. Returns (H, hd)."""
    h, hd = q.shape
    s, kv, _ = k.shape
    g = h // kv
    qg = q.reshape(kv, g, hd).float()
    kf = k.transpose(0, 1).float()                      # (kv, S, hd)
    vf = v.transpose(0, 1).float()
    scores = torch.einsum("hgd,hsd->hgs", qg, kf) / math.sqrt(hd)
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos <= pos
    if window > 0:
        mask &= k_pos > pos - window
    scores = torch.where(mask[None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgs,hsd->hgd", probs, vf)
    return out.reshape(h, hd).to(q.dtype)
