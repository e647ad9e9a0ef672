"""The Mamba2 (SSD) sequence mixer of the port's hybrid models.

The port's counterpart of the Mamba2 half of `repro.models.ssm`
(arXiv:2405.21060, as Zamba2 uses it): a depthwise causal conv1d on the
xBC stream, a scalar decay A per head, a (n_heads, head_dim, d_state)
state and a gated output.  Op for op and dtype for dtype the reference's,
so the same weights give the same numbers, with one difference: the SSD
core is one call to the hand-written `ssd_chunk_scan` for every T.  On
CUDA tensors that launches the decode kernel (T <= 16) or the chunk
kernel and raises if it cannot; on CPU tensors it runs the kernel's plain
version.  The reference takes its chunked form for T a multiple of 256
and a step-by-step scan otherwise; both compute the same recurrence, in
another summation order.

The RWKV6 half of the reference module is not ported yet (ROADMAP Queue 1
item 3).
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
