"""Shared neural-net layers of the port's models (plain PyTorch functions).

The port's counterpart of `repro.models.layers`, op for op and dtype for
dtype, so the same weights give the same numbers:

  * params are plain dicts of tensors (one dict per layer; the model keeps
    one per layer rather than the reference's stacked scan axis);
  * every attention variant has a full-sequence causal mode (forward and
    prefill) and a one-token decode mode against a KV cache;
  * shapes: x (B, T, D); caches (B, S, n_kv, hd).

Decode writes the new key and value into the cache in place (the
reference returns an updated copy); the functions still return the cache
so callers read the same either way.  The reference's sharding
constraints are identities without a mesh and are left out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_NEG_INF = -1e30


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to x's dtype, then scale in that dtype
    (the reference's order: a bf16 model rounds before the scale)."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale


# ----------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float,
                     device: Union[str, torch.device, None] = None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T).  Rotates the two halves of
    each head (not interleaved pairs) at fp32 angles; result in x's
    dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention
def _causal_mask(q_len: int, k_len: int, q_offset: int = 0, window: int = 0,
                 device: Union[str, torch.device, None] = None
                 ) -> torch.Tensor:
    """(q_len, k_len) boolean mask; window > 0 adds a sliding window."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(k_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,hd) k/v: (B,S,Hkv,hd) grouped-query attention core.

    `mask` is (T, S) shared across the batch, or (B, T, S) when rows mask
    different key ranges.  The score product runs in q's dtype and is
    divided by sqrt(hd) in fp32 (the reference divides by a numpy scalar,
    which promotes), or multiplied by `scale` where one is given; masked
    scores are -1e30, not -inf, so a fully masked row (a free scheduler
    slot) softmaxes to uniform weights, not NaN; the fp32 softmax is cast
    back to q's dtype before the value product."""
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, t, hkv, group, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).float()
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    m = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    scores = torch.where(m, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(b, t, h, hd)


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0          # 0 = full


def _normal(generator: torch.Generator, shape, dtype: torch.dtype,
            scale: float) -> torch.Tensor:
    """N(0, 1) draws times `scale`, on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype).mul_(scale)


def init_attention(generator: torch.Generator, d_model: int, spec: AttnSpec,
                   dtype: torch.dtype = torch.bfloat16) -> Params:
    """The reference's shapes and scales (fan-in scaled normals, zero
    biases, unit q/k norms), drawn from `generator` on its device."""
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    s = 1.0 / math.sqrt(d_model)
    dev = generator.device
    p = {
        "wq": _normal(generator, (d_model, h * hd), dtype, s),
        "wk": _normal(generator, (d_model, kv * hd), dtype, s),
        "wv": _normal(generator, (d_model, kv * hd), dtype, s),
        "wo": _normal(generator, (h * hd, d_model), dtype,
                      1.0 / math.sqrt(h * hd)),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    if spec.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: Params, x: torch.Tensor, spec: AttnSpec,
                 positions: torch.Tensor):
    b, t, _ = x.shape
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, h, hd)
    k = k.reshape(b, t, kv, hd)
    v = v.reshape(b, t, kv, hd)
    if spec.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


# sequences at/above this length take the memory-bounded flash path
FLASH_THRESHOLD = 2048
DECODE_FLASH_THRESHOLD = 8192


def _attend(q, k, v, spec: AttnSpec) -> torch.Tensor:
    t = q.shape[1]
    if t >= FLASH_THRESHOLD:
        from repro_torch.models.flash import flash_full
        return flash_full(q, k, v, window=spec.sliding_window)
    mask = _causal_mask(t, t, window=spec.sliding_window, device=q.device)
    return attention_scores(q, k, v, mask)


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device).expand(b, t)


def attention_full(p: Params, x: torch.Tensor,
                   spec: AttnSpec) -> torch.Tensor:
    """Causal self-attention over the whole sequence (train / prefill)."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, spec, _positions(b, t, x.device))
    out = _attend(q, k, v, spec)
    return out.reshape(b, t, -1) @ p["wo"]


def _write_decode_kv(cache: torch.Tensor, new: torch.Tensor,
                     pos: Union[int, torch.Tensor]) -> None:
    """Write one position per row into `cache` (B, S, kv, hd) in place.

    A scalar `pos` writes every row at one position, clamped into [0, S-1]
    as `dynamic_update_slice` clamps its start; a (B,) `pos` scatters per
    row, dropping rows whose position lies outside the cache (as the
    reference's scatter drops them) and wrapping negative ones."""
    s = cache.shape[1]
    if isinstance(pos, int):
        at = min(max(pos, 0), s - 1)
        cache[:, at] = new[:, 0].to(cache.dtype)
        return
    # no boolean indexing (it would sync with the host): a dropped row
    # writes back what its slot already holds
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.remainder(s)
    keep = ((pos >= -s) & (pos < s))[:, None, None]
    cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype),
                                  cache[rows, at])


def attention_decode(p: Params, x: torch.Tensor, spec: AttnSpec,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: Union[int, torch.Tensor],
                     start: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D); cache: (B,S,kv,hd), written in place.

    `pos` is a shared scalar (an int or a 0-d tensor), or a (B,) tensor
    when rows sit at different timeline positions (continuous batching:
    each slot has its own clock).  `start` is an optional (B,) tensor of
    first-valid cache positions; keys below it are masked out (left-padded
    batches).  The flash-decode path only takes the shared-scalar unpadded
    case, so per-row timelines take the masked dense path at any cache
    length."""
    b = x.shape[0]
    s = cache_k.shape[1]
    if torch.is_tensor(pos) and pos.dim() == 0:
        pos = int(pos)
    per_row = torch.is_tensor(pos)
    pos_b = (pos.to(x.device) if per_row else
             torch.full((b,), pos, dtype=torch.long, device=x.device))
    q, k, v = _project_qkv(p, x, spec, pos_b[:, None])
    _write_decode_kv(cache_k, k, pos_b if per_row else pos)
    _write_decode_kv(cache_v, v, pos_b if per_row else pos)
    if s >= DECODE_FLASH_THRESHOLD and not per_row and start is None:
        from repro_torch.models.flash import flash_decode
        out = flash_decode(q, cache_k.to(q.dtype), cache_v.to(q.dtype), pos,
                           window=spec.sliding_window)
    else:
        k_pos = torch.arange(s, device=x.device)
        mask = k_pos[None, :] <= pos_b[:, None]                  # (B, S)
        if spec.sliding_window > 0:
            mask &= k_pos[None, :] > pos_b[:, None] - spec.sliding_window
        if start is not None:
            mask &= k_pos[None, :] >= start[:, None]
        out = attention_scores(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                               mask[:, None, :])
    return out.reshape(b, 1, -1) @ p["wo"], cache_k, cache_v


# ------------------------------------------------------------------- mlp
def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.bfloat16) -> Params:
    s_in = 1.0 / math.sqrt(d_model)
    return {
        "w_gate": _normal(generator, (d_model, d_ff), dtype, s_in),
        "w_up": _normal(generator, (d_model, d_ff), dtype, s_in),
        "w_down": _normal(generator, (d_ff, d_model), dtype,
                          1.0 / math.sqrt(d_ff)),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def attention_prefill(p: Params, x: torch.Tensor, spec: AttnSpec,
                      start: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """Causal self-attention returning (out, (k, v)) for cache filling.

    `start` is an optional (B,) tensor of first real token positions for
    left-padded batches; keys before a row's start never enter its
    softmax, so a padded prompt attends exactly as it would alone (RoPE
    phases are relative, so the constant position shift cancels)."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, spec, _positions(b, t, x.device))
    if start is None:
        out = _attend(q, k, v, spec)
    else:
        mask = _causal_mask(t, t, window=spec.sliding_window,
                            device=x.device)                     # (t, t)
        mask = mask[None] & (torch.arange(t, device=x.device)[None, None, :]
                             >= start[:, None, None])            # (B, t, t)
        out = attention_scores(q, k, v, mask)
    return out.reshape(b, t, -1) @ p["wo"], (k, v)
