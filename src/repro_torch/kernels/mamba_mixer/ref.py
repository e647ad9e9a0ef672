"""Plain PyTorch versions of the Mamba2 mixer's two pointwise kernels, in
the arithmetic of the published Zamba2's mixer (`models/zamba2_published`)
expression for expression: the conv over the concatenation of the carry
and xBC in fp32, the first tap times its weight plus the bias, then each
later tap's product added in order (`addcmul_`), SiLU, and softplus(dt +
dt_bias); the gated norm (y + D xs) silu(z), normalised by the rsqrt of
its mean square plus eps, times the gate, cast to the model dtype.

The conv's outputs are group-major, (G, B, T, ...) contiguous, as the
kernel writes them: group g's heads of xs, its B and C, and its heads of
dt, each dense for that group's scan call."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def group_major(x: torch.Tensor) -> torch.Tensor:
    """(B, T, G, ...) -> contiguous (G, B, T, ...)."""
    return x.movedim(2, 0).contiguous()


def mamba_conv_silu_ref(xbc: torch.Tensor, carry: torch.Tensor,
                        conv_w: torch.Tensor, conv_b: torch.Tensor,
                        dt_raw: torch.Tensor, dt_bias: torch.Tensor, *,
                        ngroups: int, headdim: int
                        ) -> Tuple[torch.Tensor, ...]:
    """xbc (B, T, conv_dim) and carry (B, K - 1, conv_dim), conv_w (K,
    conv_dim), conv_b (conv_dim,), dt_raw (B, T, H), dt_bias (H,).
    Returns fp32 xs (G, B, T, H / G, P), B and C (G, B, T, N) and dt (G,
    B, T, H / G)."""
    b, t, _ = xbc.shape
    k, h = conv_w.shape[0], dt_raw.shape[-1]
    d_inner = h * headdim
    n = (xbc.shape[-1] - d_inner) // (2 * ngroups)
    ext = torch.cat([carry, xbc], dim=1)              # (B, T + K - 1, C)
    extf, w = ext.float(), conv_w.float()
    acc = extf[:, 0:t] * w[0] + conv_b.float()
    for i in range(1, k):
        acc.addcmul_(extf[:, i:i + t], w[i])
    xs, bmat, cmat = torch.split(F.silu(acc),
                                 [d_inner, ngroups * n, ngroups * n], dim=-1)
    dt = F.softplus(dt_raw.float() + dt_bias)
    hg = h // ngroups
    return (group_major(xs.reshape(b, t, ngroups, hg, headdim)),
            group_major(bmat.reshape(b, t, ngroups, n)),
            group_major(cmat.reshape(b, t, ngroups, n)),
            group_major(dt.reshape(b, t, ngroups, hg)))


def gated_rms_norm_ref(y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
                       d: torch.Tensor, gate: torch.Tensor, *,
                       eps: float) -> torch.Tensor:
    """One group: y and xs (B, T, H / G, P) fp32, z (B, T, H / G x P), d
    (H / G,) and gate (H / G x P,).  Returns (B, T, H / G x P) in z's
    dtype."""
    b, t, hg, p = y.shape
    v = (y + d[:, None] * xs).reshape(b, t, hg * p)
    v = v * F.silu(z.float())
    v = v * torch.rsqrt(v.square().mean(-1, keepdim=True) + eps)
    return (v * gate).to(z.dtype)
