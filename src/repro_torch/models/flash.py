"""Memory-bounded attention by chunked online softmax (plain PyTorch).

The port's counterpart of `repro.models.flash`: above a sequence
threshold the attention paths of `models/layers.py` and `models/mla.py`
stop materialising (T, S) scores and walk key chunks with a running
(max, sum, accumulator) per query row instead.

  * flash_full: an outer loop over query chunks, an inner loop over key
    chunks; live intermediates are (bq, bk) score tiles per (batch, head).
  * flash_decode: one query position against a long cache, walked over
    key chunks (the plain twin of the `decode_attention` kernel).
  * flash_latent_full / flash_latent_decode: the same two walks for MLA's
    absorbed attention, whose keys are the shared latent `c_kv` plus one
    rope head and whose values are `c_kv` itself; they return the latent
    context, which `models/mla.py` maps through W_uv.

Causality and sliding windows are positional masks applied per tile;
fully masked tiles still run, as in the reference.  All sums are fp32;
outputs come back in the query's dtype.

Each key loop carries only its running state and its tiles have equal
shapes, so it walks through `core.loops.counted_range`: `range`
here, and two iterations, the second weighed by the rest, when the dry
run counts a step on fake tensors (the reference's `lax.scan` trip
count).
"""
from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.core.loops import counted_range

_NEG_INF = -1e30


def _tile_mask(q0: int, k0: int, bq: int, bk: int, window: int,
               device) -> torch.Tensor:
    q_pos = q0 + torch.arange(bq, device=device)[:, None]
    k_pos = k0 + torch.arange(bk, device=device)[None, :]
    m = k_pos <= q_pos
    if window > 0:
        m &= k_pos > q_pos - window
    return m


def flash_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int = 0, bq: int = 1024,
               bk: int = 1024) -> torch.Tensor:
    """Causal GQA attention. q: (B,T,H,hd); k/v: (B,S,KV,hd) -> (B,T,H,hd)."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    bq = min(bq, t)
    bk = min(bk, s)
    if t % bq or s % bk:
        raise ValueError(f"flash_full: T={t} and S={s} must be multiples of "
                         f"the chunks bq={bq}, bk={bk}")
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, t, kv, g, hd)
    chunks = []
    for qi in range(t // bq):
        qc = qg[:, qi * bq:(qi + 1) * bq].float() * scale     # (B,bq,KV,g,hd)
        m_run = torch.full((b, kv, g, bq), _NEG_INF, device=q.device)
        l_run = torch.zeros((b, kv, g, bq), device=q.device)
        acc = torch.zeros((b, kv, g, bq, hd), device=q.device)
        for ki in counted_range(s // bk):
            kc = k[:, ki * bk:(ki + 1) * bk].float()          # (B,bk,KV,hd)
            vc = v[:, ki * bk:(ki + 1) * bk].float()
            scores = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc)
            mask = _tile_mask(qi * bq, ki * bk, bq, bk, window, q.device)
            scores = torch.where(mask, scores, _NEG_INF)
            m_new = torch.maximum(m_run, scores.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(scores - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                        p, vc)
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        chunks.append(out.to(q.dtype))                         # (B,KV,g,bq,hd)
    # (B, KV, g, T, hd) -> (B, T, H, hd)
    out = torch.cat(chunks, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: Union[int, torch.Tensor], *, window: int = 0,
                 bk: int = 2048) -> torch.Tensor:
    """One-token decode. q: (B,1,H,hd); k/v: (B,S,KV,hd) -> (B,1,H,hd);
    `pos` is the shared position of the query (keys above it are
    masked)."""
    b, _, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    bk = min(bk, s)
    if s % bk:
        raise ValueError(f"flash_decode: S={s} must be a multiple of the "
                         f"chunk bk={bk}")
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, kv, g, hd).float() * scale
    m_run = torch.full((b, kv, g), _NEG_INF, device=q.device)
    l_run = torch.zeros((b, kv, g), device=q.device)
    acc = torch.zeros((b, kv, g, hd), device=q.device)
    for ki in counted_range(s // bk):
        kc = k[:, ki * bk:(ki + 1) * bk].float()
        vc = v[:, ki * bk:(ki + 1) * bk].float()
        scores = torch.einsum("bhgd,bkhd->bhgk", qf, kc)
        k_pos = ki * bk + torch.arange(bk, device=q.device)
        mask = k_pos <= pos
        if window > 0:
            mask &= k_pos > pos - window
        scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vc)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def flash_latent_full(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_kv: torch.Tensor, k_rope: torch.Tensor, scale: float,
                      *, bq: int = 1024, bk: int = 1024) -> torch.Tensor:
    """Causal MLA latent attention.  q_lat: (B,T,H,r) absorbed queries;
    q_rope: (B,T,H,rd); c_kv: (B,S,r); k_rope: (B,S,rd) -> the latent
    context (B,T,H,r) in q_lat's dtype."""
    b, t, h, r = q_lat.shape
    s = c_kv.shape[1]
    bq = min(bq, t)
    bk = min(bk, s)
    if t % bq or s % bk:
        raise ValueError(f"flash_latent_full: T={t} and S={s} must be "
                         f"multiples of the chunks bq={bq}, bk={bk}")
    chunks = []
    for qi in range(t // bq):
        qlf = q_lat[:, qi * bq:(qi + 1) * bq].float()        # (B,bq,H,r)
        qrf = q_rope[:, qi * bq:(qi + 1) * bq].float()
        m_run = torch.full((b, h, bq), _NEG_INF, device=q_lat.device)
        l_run = torch.zeros((b, h, bq), device=q_lat.device)
        acc = torch.zeros((b, h, bq, r), device=q_lat.device)
        for ki in counted_range(s // bk):
            ck = c_kv[:, ki * bk:(ki + 1) * bk].float()       # (B,bk,r)
            kr = k_rope[:, ki * bk:(ki + 1) * bk].float()
            scores = (torch.einsum("bqhr,bkr->bhqk", qlf, ck)
                      + torch.einsum("bqhd,bkd->bhqk", qrf, kr)) * scale
            mask = _tile_mask(qi * bq, ki * bk, bq, bk, 0, q_lat.device)
            scores = torch.where(mask, scores, _NEG_INF)
            m_new = torch.maximum(m_run, scores.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(scores - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkr->bhqr",
                                                        p, ck)
            m_run = m_new
        ctx = acc / torch.clamp(l_run, min=1e-30)[..., None]
        chunks.append(ctx.to(q_lat.dtype))                   # (B,H,bq,r)
    return torch.cat(chunks, dim=2).permute(0, 2, 1, 3)


def flash_latent_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                        c_kv: torch.Tensor, k_rope: torch.Tensor,
                        pos: Union[int, torch.Tensor], scale: float, *,
                        bk: int = 2048) -> torch.Tensor:
    """One-token MLA decode.  q_lat: (B,1,H,r); q_rope: (B,1,H,rd); caches
    (B,S,r) and (B,S,rd); `pos` is the shared position of the query (keys
    above it are masked) -> the latent context (B,1,H,r)."""
    b, _, h, r = q_lat.shape
    s = c_kv.shape[1]
    bk = min(bk, s)
    if s % bk:
        raise ValueError(f"flash_latent_decode: S={s} must be a multiple "
                         f"of the chunk bk={bk}")
    qlf = q_lat.reshape(b, h, r).float()
    qrf = q_rope.reshape(b, h, -1).float()
    m_run = torch.full((b, h), _NEG_INF, device=q_lat.device)
    l_run = torch.zeros((b, h), device=q_lat.device)
    acc = torch.zeros((b, h, r), device=q_lat.device)
    for ki in counted_range(s // bk):
        ck = c_kv[:, ki * bk:(ki + 1) * bk].float()
        kr = k_rope[:, ki * bk:(ki + 1) * bk].float()
        scores = (torch.einsum("bhr,bkr->bhk", qlf, ck)
                  + torch.einsum("bhd,bkd->bhk", qrf, kr)) * scale
        k_pos = ki * bk + torch.arange(bk, device=q_lat.device)
        scores = torch.where(k_pos <= pos, scores, _NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhk,bkr->bhr", p, ck)
        m_run = m_new
    ctx = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return ctx.reshape(b, 1, h, r).to(q_lat.dtype)
