"""Attention-free sequence mixers: RWKV6 ("Finch") and Mamba2 (SSD).

The port's counterpart of `repro.models.ssm`, op for op and dtype for
dtype the reference's, so the same weights give the same numbers.

RWKV6 (arXiv:2404.05892): token-shift interpolation, a data-dependent
per-channel decay w_t from a low-rank MLP, a per-head (head_dim,
head_dim) WKV state and a bonus term u, with the reference's
simplification (one shared token-shift mix per projection).  Neither of
the reference's WKV branches is a Pallas kernel, so both stay plain
PyTorch here, and both are kept: the chunked form (`_wkv_chunked`)
exactly where T >= `_WKV_CHUNK` and T % `_WKV_CHUNK` == 0, the step
recurrence (`_wkv_step`) otherwise.  The projections are `@` products,
as the reference's are.

Mamba2 (arXiv:2405.21060, as Zamba2 uses it): a depthwise causal conv1d
on the xBC stream, a scalar decay A per head, a (n_heads, head_dim,
d_state) state and a gated output, with one difference from the
reference: the SSD core is one call to the hand-written `ssd_chunk_scan`
for every T.  On CUDA tensors that launches the decode kernel (T <= 16)
or the chunk kernels and raises if it cannot; on CPU tensors it runs the
kernel's plain version.  The reference takes its chunked form for T a
multiple of 256 and a step-by-step scan otherwise; both compute the same
recurrence, in another summation order.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal

Params = Dict[str, torch.Tensor]


# =================================================================== RWKV6
def _uniform(generator: torch.Generator, shape,
             dtype: torch.dtype) -> torch.Tensor:
    """U[0, 1) draws on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=dtype)


def init_rwkv6(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.bfloat16) -> Params:
    """The reference's shapes and scales, drawn from `generator` on its
    device; `w0` and `u` are fp32 whatever `dtype` is."""
    d = cfg.d_model
    hd = cfg.ssm_head_dim
    n_heads = d // hd
    lora = 32
    s = 1.0 / math.sqrt(d)
    dev = generator.device
    return {
        "mix": _uniform(generator, (5, d), dtype),       # r,k,v,g,w shifts
        "wr": _normal(generator, (d, d), dtype, s),
        "wk": _normal(generator, (d, d), dtype, s),
        "wv": _normal(generator, (d, d), dtype, s),
        "wg": _normal(generator, (d, d), dtype, s),
        "wo": _normal(generator, (d, d), dtype, s),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "w_a": _normal(generator, (d, lora), dtype, s),
        "w_b": _normal(generator, (lora, d), dtype, 1.0 / math.sqrt(lora)),
        "u": _normal(generator, (n_heads, hd), torch.float32, 0.1),
        "ln_x": torch.ones((d,), dtype=dtype, device=dev),
    }


def _shift(x: torch.Tensor, x_last: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) shifted right by one token, `x_last` (B, D) first."""
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_projections(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                      cfg: ModelConfig):
    """x: (B,T,D); x_prev: (B,T,D) = x shifted right by one token.
    r, k, v, g in x's dtype; the decay w in fp32."""
    xx = x_prev - x
    xr, xk, xv, xg, xw = [x + xx * p["mix"][i] for i in range(5)]
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (per channel, in (0,1))
    ww = p["w0"] + (torch.tanh(xw @ p["w_a"]) @ p["w_b"]).float()
    w = torch.exp(-torch.exp(ww))
    return r, k, v, g, w


def _wkv_step(state: torch.Tensor, inputs, u: torch.Tensor):
    """state: (B,H,hd,hd); r,k,v: (B,H,hd); w: (B,H,hd)."""
    r, k, v, w = inputs
    kv = k[..., :, None] * v[..., None, :]            # (B,H,hd,hd)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    state = w[..., :, None] * state + kv
    return state, out


def rwkv6_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
              state: torch.Tensor, x_last: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-mixing over a full sequence.

    state: (B, H, hd, hd) WKV state entering this chunk;
    x_last: (B, D) last token of the previous chunk (token shift carry).
    Returns (y, new_state in state's dtype, new_x_last)."""
    b, t, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    r, k, v, g, w = _rwkv_projections(p, x, _shift(x, x_last), cfg)

    if t >= _WKV_CHUNK and t % _WKV_CHUNK == 0:
        rs, ks, vs, ws = (z.reshape(b, t, h, hd).float()
                          for z in (r, k, v, w))
        state_f, y = _wkv_chunked(rs, ks, vs, ws, p["u"], state.float())
    else:
        rs, ks, vs, ws = (z.reshape(b, t, h, hd).transpose(0, 1).float()
                          for z in (r, k, v, w))       # (T,B,H,hd)
        state_f, outs = state.float(), []
        for i in range(t):
            state_f, out = _wkv_step(state_f, (rs[i], ks[i], vs[i], ws[i]),
                                     p["u"])
            outs.append(out)
        y = torch.stack(outs, dim=1)                   # (B,T,H,hd)
    y = y.reshape(b, t, d).to(x.dtype)
    # per-head group norm: the mean in x's dtype, the variance in fp32
    y = y.reshape(b, t, h, hd)
    mu = y.mean(-1, keepdim=True)
    var = y.float().var(-1, keepdim=True, correction=0)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).to(x.dtype)
    y = y.reshape(b, t, d) * p["ln_x"]
    y = (y * g) @ p["wo"]
    return y, state_f.to(state.dtype), x[:, -1, :]


def init_rwkv_channel_mix(generator: torch.Generator, cfg: ModelConfig,
                          dtype: torch.dtype = torch.bfloat16) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mix_k": _uniform(generator, (d,), dtype),
        "wk": _normal(generator, (d, ff), dtype, 1.0 / math.sqrt(d)),
        "wv": _normal(generator, (ff, d), dtype, 1.0 / math.sqrt(ff)),
    }


def rwkv_channel_mix(p: Params, x: torch.Tensor, x_last: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D), x_last (B, D) -> (y (B, T, D), new x_last)."""
    xk = x + (_shift(x, x_last) - x) * p["mix_k"]
    h = torch.square(F.relu(xk @ p["wk"]))
    return h @ p["wv"], x[:, -1, :]


def rwkv6_state_shapes(cfg: ModelConfig, batch: int):
    h = cfg.d_model // cfg.ssm_head_dim
    return ((batch, h, cfg.ssm_head_dim, cfg.ssm_head_dim),
            (batch, cfg.d_model))


# ------------------------------------------------------------ chunked WKV
_WKV_CHUNK = 64
_WKV_SUB = 16


def _wkv_chunked(r, k, v, w, u, state0):
    """Chunked RWKV6 WKV — exact, numerically-safe two-level scheme.

    r/k/v: (B,T,H,hd) f32; w: (B,T,H,hd) per-channel decay in (0,1);
    u: (H,hd); state0: (B,H,hd,hd).  Returns (final_state, out).

    The naive two-factor trick exp(l_{t-1}) * exp(-l_j) overflows/clamps
    under strong decay, so exponents are re-centered per length-16
    sub-chunk: with ref_s = l at sub-chunk s entry,
        A[t, (s,j)] = sum_k r_t exp(l_{t-1}-ref_s) . k_j exp(ref_s-l_j)
    both exponents are bounded (<=0, and <= 16 steps of decay resp.).
    A query's exponent outside its sub-chunks is set to -inf before the
    exp (it can be large and positive), never masked after it.
    """
    b, t, h, hd = r.shape
    L, c = _WKV_CHUNK, _WKV_SUB
    ns = L // c
    dev = r.device
    strict = torch.ones(L, L, dtype=torch.bool, device=dev).tril(-1)
    sub_of = torch.arange(L, device=dev) // c                   # (L,)
    valid_ts = sub_of[:, None] >= torch.arange(ns, device=dev)[None, :]
    valid_ts = valid_ts[None, :, :, None, None]                 # (1,L,ns,1,1)
    s0, outs = state0, []
    for t0 in range(0, t, L):
        rk, kk, vk, wk = (z[:, t0:t0 + L] for z in (r, k, v, w))
        logw = torch.log(torch.clamp_min(wk, 1e-38))
        l = torch.cumsum(logw, dim=1)                          # <= 0
        l_prev = l - logw                                      # l_{t-1}
        ref = l_prev.reshape(b, ns, c, h, hd)[:, :, 0]         # (B,ns,H,hd)

        # queries re-centered at each sub-chunk reference
        e_r = l_prev[:, :, None] - ref[:, None]                # (B,L,ns,H,hd)
        rdx = rk[:, :, None] * torch.where(valid_ts, e_r,
                                           -torch.inf).exp()
        # keys re-centered at their own sub-chunk reference
        e_k = ref[:, :, None] - l.reshape(b, ns, c, h, hd)     # (B,ns,c,H,hd)
        kdx = kk.reshape(b, ns, c, h, hd) * torch.exp(e_k)

        a = torch.einsum("btshk,bsjhk->bhtsj", rdx, kdx).reshape(b, h, L, L)
        a = torch.where(strict, a, torch.zeros((), device=dev))
        out_intra = torch.einsum("bhtj,bjhv->bthv", a, vk)
        diag = torch.einsum("blhk,blhk->blh", rk * u[None, None], kk)
        out_inter = torch.einsum("blhk,bhkv->blhv", rk * torch.exp(l_prev),
                                 s0)
        outs.append(out_inter + out_intra + diag[..., None] * vk)

        decay_to_end = torch.exp(l[:, -1:] - l)                # (B,L,H,hd)
        s0 = torch.exp(l[:, -1])[:, :, :, None] * s0 + torch.einsum(
            "bjhk,bjhv->bhkv", kk * decay_to_end, vk)
    return s0, torch.cat(outs, dim=1)


# ================================================================== Mamba2
_CONV_K = 4


def init_mamba2(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """The reference's shapes and scales, drawn from `generator` on its
    device; `A_log`, `D` and `dt_bias` are fp32 whatever `dtype` is."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    n_heads = d_in // cfg.ssm_head_dim
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # projections: z (gate), x, B, C, dt
        "w_in": _normal(generator, (d, 2 * d_in + 2 * n + n_heads), dtype,
                        1.0 / math.sqrt(d)),
        "conv_w": _normal(generator, (_CONV_K, d_in + 2 * n), dtype, 0.3),
        "A_log": torch.zeros((n_heads,), **f32),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "norm_z": torch.ones((d_in,), dtype=dtype, device=dev),
        "w_out": _normal(generator, (d_in, d), dtype, 1.0 / math.sqrt(d_in)),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           carry: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,C); w: (K,C); carry: (B,K-1,C) previous inputs.  The K taps
    summed in order in x's dtype, as the reference sums them."""
    ext = torch.cat([carry, x], dim=1)                    # (B, T+K-1, C)
    k, t = w.shape[0], x.shape[1]
    out = sum(ext[:, i:i + t, :] * w[i] for i in range(k))
    new_carry = ext[:, -(k - 1):, :] if k > 1 else carry
    return out, new_carry


def mamba2_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: torch.Tensor, conv_carry: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SSD over a sequence.  x: (B, T, D); state: (B, H, hd, N);
    conv_carry: (B, K-1, C).  Returns (y (B, T, D), final state in
    state's dtype, new conv carry)."""
    b, t, d = x.shape
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    h = d_in // hd

    proj = x @ p["w_in"]
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)
    xbc, new_carry = _causal_depthwise_conv(xbc, p["conv_w"], conv_carry)
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)

    # jax.nn.softplus is logaddexp(u, 0), with no linear threshold
    u = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(u, torch.zeros((), device=u.device))   # (B,T,H)
    a = -torch.exp(p["A_log"])                                  # (H,)

    xs_h = xs.reshape(b, t, h, hd).float()
    # the kernel takes contiguous operands; the splits above are views
    state_f, y = ssd_chunk_scan(
        xs_h.contiguous(), bmat.float().contiguous(),
        cmat.float().contiguous(), dt.contiguous(), a.contiguous(),
        state.float().contiguous())
    y = y + p["D"][None, None, :, None] * xs_h
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = y * F.silu(z) * p["norm_z"]
    return y @ p["w_out"], state_f.to(state.dtype), new_carry


def mamba2_state_shapes(cfg: ModelConfig, batch: int):
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    return ((batch, h, cfg.ssm_head_dim, cfg.ssm_state),
            (batch, _CONV_K - 1, d_in + 2 * cfg.ssm_state))
