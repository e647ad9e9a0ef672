"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), plain PyTorch.

The port's counterpart of `repro.models.mla`, op for op and dtype for
dtype.  K and V are projected through a low-rank latent `c_kv`
(kv_lora_rank); the KV cache stores only (c_kv, k_rope), one shared rope
head.  Attention runs *absorbed*: W_uk is folded into the query, so the
scores are taken directly against the latent, and W_uv maps the latent
context back to the heads before `wo`.

Above the reference's thresholds (a prefill of `_FLASH_THRESHOLD` tokens,
a cache of `_DECODE_FLASH_THRESHOLD` positions) the latent attention walks
key chunks (`flash_latent_full` / `flash_latent_decode`); below them it
materialises the (T, S) scores.  Decode writes the new latent and rope key
into the cache in place at the shared scalar `pos` (clamped into the
cache, as `dynamic_update_slice` clamps) and still returns both caches.
The reference's sharding constraint on the query projection is an
identity without a mesh and is left out.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_normal, _positions, apply_rope,
                                       rms_norm)

Params = Dict[str, torch.Tensor]
_NEG_INF = -1e30

#: a prefill of this many tokens takes the flash path; a decode step does
#: when its cache holds this many positions (the reference's thresholds)
_FLASH_THRESHOLD = 2048
_DECODE_FLASH_THRESHOLD = 8192


def init_mla(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.bfloat16) -> Params:
    """The reference's shapes and scales, drawn from `generator` on its
    device."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    s = 1.0 / math.sqrt(d)
    sr = 1.0 / math.sqrt(r)
    return {
        "wq": _normal(generator, (d, h * (nd + rd)), dtype, s),
        "w_dkv": _normal(generator, (d, r), dtype, s),
        "w_krope": _normal(generator, (d, rd), dtype, s),
        "w_uk": _normal(generator, (r, h, nd), dtype, sr),
        "w_uv": _normal(generator, (r, h, vd), dtype, sr),
        "wo": _normal(generator, (h * vd, d), dtype, 1.0 / math.sqrt(h * vd)),
        "kv_norm": torch.ones((r,), dtype=dtype, device=generator.device),
    }


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _queries(p: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    b, t, _ = x.shape
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["w_krope"]                       # one shared rope head
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _out(p: Params, ctx: torch.Tensor) -> torch.Tensor:
    """The latent context (B,T,H,r) through W_uv and `wo`."""
    out = torch.einsum("bthr,rhv->bthv", ctx, p["w_uv"])
    b, t = out.shape[:2]
    return out.reshape(b, t, -1) @ p["wo"]


def _attend_latent(p: Params, q_nope, q_rope, c_kv, k_rope,
                   mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Absorbed attention in latent space.  q_nope: (B,T,H,nd); q_rope:
    (B,T,H,rd); c_kv: (B,S,r); k_rope: (B,S,rd); mask (T,S) or (1,S).  The
    score products run in the input dtype, the masked softmax in fp32,
    cast back before the value product."""
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, p["w_uk"])   # absorb W_uk
    scores = (torch.einsum("bthr,bsr->bhts", q_lat, c_kv)
              + torch.einsum("bthd,bsd->bhts", q_rope, k_rope)) * _scale(cfg)
    scores = torch.where(mask, scores.float(), _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    ctx = torch.einsum("bhts,bsr->bthr", probs, c_kv)           # latent ctx
    return _out(p, ctx)


def _attend_auto(p: Params, q_nope, q_rope, c_kv, k_rope,
                 cfg: ModelConfig) -> torch.Tensor:
    """Causal latent attention; the chunked flash walk for long prefills."""
    t = q_nope.shape[1]
    if t >= _FLASH_THRESHOLD:
        from repro_torch.models.flash import flash_latent_full
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope, p["w_uk"])
        return _out(p, flash_latent_full(q_lat, q_rope, c_kv, k_rope,
                                         _scale(cfg)))
    ar = torch.arange(t, device=q_nope.device)
    mask = ar[None, :] <= ar[:, None]
    return _attend_latent(p, q_nope, q_rope, c_kv, k_rope, mask, cfg)


def mla_full(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Causal MLA over the whole sequence.  x: (B,T,D) -> (B,T,D)."""
    b, t, _ = x.shape
    positions = _positions(b, t, x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)
    return _attend_auto(p, q_nope, q_rope, c_kv, k_rope, cfg)


def mla_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal MLA returning (out, (c_kv, k_rope)) for the latent cache."""
    b, t, _ = x.shape
    positions = _positions(b, t, x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)
    return _attend_auto(p, q_nope, q_rope, c_kv, k_rope, cfg), (c_kv, k_rope)


def mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
               cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
               pos: Union[int, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (B,1,D); cache_ckv: (B,S,r); cache_krope:
    (B,S,rd), both written in place at the shared scalar `pos` (an int or
    a 0-d tensor)."""
    b = x.shape[0]
    s = cache_ckv.shape[1]
    if torch.is_tensor(pos):
        pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)
    at = min(max(pos, 0), s - 1)          # dynamic_update_slice's clamp
    cache_ckv[:, at] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[:, at] = k_rope[:, 0].to(cache_krope.dtype)
    ckv, krope = cache_ckv.to(x.dtype), cache_krope.to(x.dtype)
    if s >= _DECODE_FLASH_THRESHOLD:
        from repro_torch.models.flash import flash_latent_decode
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope, p["w_uk"])
        out = _out(p, flash_latent_decode(q_lat, q_rope, ckv, krope, pos,
                                          _scale(cfg)))
    else:
        mask = (torch.arange(s, device=x.device) <= pos)[None, :]
        out = _attend_latent(p, q_nope, q_rope, ckv, krope, mask, cfg)
    return out, cache_ckv, cache_krope
