"""Zamba2 as published, written out plainly in fp32: the reference that
decides `correct` for a Zamba2 configuration, and its control.

The equations are those of Zyphra's released models (arXiv:2411.15242)
as `transformers`' `Zamba2ForCausalLM` computes them, read from the
configuration's own keys (`hidden_size`, `layers_block_type` or
`hybrid_layer_ids`, `num_mem_blocks`, `attention_head_dim`,
`mamba_ngroups`, ...).  Per token, x0 the embedding's output:

- at a hybrid layer j, shared block j % num_mem_blocks on concat[x, x0]:
  RMSNorm; q, k, v; RoPE over the whole head (rotate-half, `rope_theta`);
  causal softmax attention with scores times (head_dim / 2) ** -0.5;
  o_proj; RMSNorm; gelu(g) * u with [g, u] = h W_gate_up + (h A_j) B_j;
  W_down; then layer j's own `linear`: t.  The Mamba layer then reads
  RMSNorm(x + t), and x <- x + its output;
- every layer's Mamba2 mixer: in_proj to [z | xBC | dt]; a depthwise
  causal conv1d with bias over xBC, SiLU; dt = softplus(dt + dt_bias),
  no limit; A = -exp(A_log); the SSD scan per group of heads, each group
  reading its own B and C; the D skip; the gated RMSNorm (y silu(z),
  normalised over each group's channels, eps 1e-5); out_proj;
- a final RMSNorm and the lm_head tied to the embedding.

One departure from `transformers`' eager path, none from the published
model: that path clamps dt below at `time_step_min`, where the CUDA path
the released checkpoints run (`mamba_ssm`'s kernels) applies no limit
when `time_step_limit` is null.  This reference follows the CUDA path.

The SSD scan is the Mamba2 paper's minimal chunked listing (arXiv:
2405.21060, Listing 1) over chunks of the configuration's `chunk_size`,
one batch row and one group at a time; attention walks query chunks of
1024 rows.  Each layer's weights are upcast from the tensors they are
given as the layer runs, so no fp32 copy of the model is held.

The weights are a dict: `embed` (V, d); `final_norm` (d,); `blocks`, one
dict per shared block (`in_norm` (2d,), `w_qkv` (2d, 3 * 2d) as [q | k |
v] columns, `wo` (2d, d), `ff_norm` (d,), `w_gate_up` (d, 2F) as [g | u],
`w_down` (F, d)); `hybrid`, one dict per hybrid layer (`lora_a` (d, r),
`lora_b` (r, 2F), `linear` (d, d)); `layers`, one dict per layer
(`norm` (d,), `w_in` (d, d_in + conv_dim + H), `conv_w` (K, conv_dim),
`conv_b` (conv_dim,), `dt_bias`, `A_log`, `D` (H,), `norm_gate`
(d_in,), `w_out` (d_in, d)).  Every product is x @ W.

`init` draws those weights from a seeded generator as the published
`Zamba2PreTrainedModel._init_weights` sets the mixer's own (A_log =
log(1..H), D = 1, dt_bias the inverse softplus of a log-uniform dt), with
norms 1 and every other weight N(0, 1 / fan_in).  The benchmark draws
them, hands them to the program and keeps its own copy on the host for
the reference, so neither a wrong init rule nor a weight the program
changes in place reads the same on both sides.

`CONTROL`, the nearest precision below bf16, rounds each operand of every
product (the projections, the conv, attention's two products, the SSD's
contractions, the lm_head) to float8 e4m3 with one scale per operand, as
an fp8 product does, and sums in fp32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.counts_zamba2 import hybrid_ids
from portbench.reference.precision import EXACT, Precision, no_tf32

#: the configuration's `dtype` as a torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the largest finite float8 e4m3 value
_E4M3_MAX = 448.0
#: query rows attention takes at once
_Q_CHUNK = 1024
#: the gated RMSNorm's epsilon, fixed in the published mixer
_GATED_EPS = 1e-5


def init(cfg: Mapping[str, Any], generator: torch.Generator
         ) -> Dict[str, Any]:
    """Seeded weights in `cfg["dtype"]` on the generator's device, laid
    out as `logits` reads them; dt_bias, A_log and D in fp32."""
    dtype, dev = DTYPES[cfg["dtype"]], generator.device
    d, f, r = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["adapter_rank"]
    wide = 2 * d
    d_in = cfg["mamba_expand"] * d
    heads, k = cfg["n_mamba_heads"], cfg["mamba_d_conv"]
    conv_dim = d_in + 2 * cfg["mamba_ngroups"] * cfg["mamba_d_state"]

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype).mul_(fan_in ** -0.5)

    def ones(n, dt=dtype):
        return torch.ones((n,), dtype=dt, device=dev)

    def dt_bias():
        u = torch.rand((heads,), generator=generator, device=dev)
        lo, hi = math.log(cfg["time_step_min"]), \
            math.log(cfg["time_step_max"])
        dt = torch.exp(u * (hi - lo) + lo).clamp(min=cfg["time_step_floor"])
        return dt + torch.log(-torch.expm1(-dt))

    weights: Dict[str, Any] = {"embed": normal((cfg["vocab_size"], d), d)}
    weights["blocks"] = [{
        "in_norm": ones(wide),
        "w_qkv": normal((wide, 3 * wide), wide),
        "wo": normal((wide, d), wide),
        "ff_norm": ones(d),
        "w_gate_up": normal((d, 2 * f), d),
        "w_down": normal((f, d), f),
    } for _ in range(cfg["num_mem_blocks"])]
    weights["hybrid"] = [{
        "lora_a": normal((d, r), d),
        "lora_b": normal((r, 2 * f), r),
        "linear": normal((d, d), d),
    } for _ in hybrid_ids(cfg)]
    weights["layers"] = [{
        "norm": ones(d),
        "w_in": normal((d, d_in + conv_dim + heads), d),
        "conv_w": normal((k, conv_dim), k),
        "conv_b": normal((conv_dim,), k),
        "dt_bias": dt_bias(),
        "A_log": torch.log(torch.arange(1, heads + 1, dtype=torch.float32,
                                        device=dev)),
        "D": ones(heads, torch.float32),
        "norm_gate": ones(d_in),
        "w_out": normal((d_in, d), d_in),
    } for _ in range(cfg["num_hidden_layers"])]
    weights["final_norm"] = ones(d)
    return weights


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x in fp32 rounded to float8 e4m3 on one scale that maps its
    largest |value| to e4m3's largest."""
    x = x.float()
    amax = float(x.abs().max()) if x.numel() else 0.0
    if amax == 0.0 or not math.isfinite(amax):
        return x
    s = _E4M3_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


#: the control of a bf16 Zamba2 configuration
CONTROL = Precision(round_e4m3)


class _Ops:
    """The products, each operand through the precision's rounding."""

    def __init__(self, prec: Precision):
        self.op = prec.operand

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.op(x) @ self.op(w)

    def einsum(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.op(x) for x in xs))


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd) at positions 0..T-1, rotate-half over all hd."""
    t, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    emb = torch.cat([ang, ang], dim=-1)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * emb.cos() + torch.cat([-x2, x1], dim=-1) * emb.sin()


def attention(q, k, v, scale: float, ops: _Ops) -> torch.Tensor:
    """Causal softmax attention, q, k, v (B, T, H, hd) -> (B, T, H, hd),
    one row and one chunk of queries at a time."""
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    for r in range(b):
        kr, vr = k[r].transpose(0, 1), v[r].transpose(0, 1)   # (H, T, hd)
        for q0 in range(0, t, _Q_CHUNK):
            q1 = min(t, q0 + _Q_CHUNK)
            qr = q[r, q0:q1].transpose(0, 1)                  # (H, c, hd)
            s = ops.einsum("hqd,hkd->hqk", qr, kr[:, :q1]) * scale
            rows = torch.arange(q0, q1, device=q.device)[:, None]
            s = s.masked_fill(torch.arange(q1, device=q.device)[None]
                              > rows, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[r, q0:q1] = ops.einsum("hqk,hkd->qhd", p, vr[:, :q1])
    return out


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry [i, j] the sum of x over (j, i] for
    j <= i, -inf above the diagonal."""
    t = x.shape[-1]
    rep = x[..., None].expand(*x.shape, t)
    strict = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device),
                        -1)
    out = torch.cumsum(rep.masked_fill(~strict, 0.0), dim=-2)
    lower = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~lower, float("-inf"))


def ssd(x, dt, a, bm, cm, chunk: int, ops: _Ops):
    """The minimal chunked SSD of one row and one group from a zero state:
    x (T, h, p), dt (T, h), a (h,), bm and cm (T, n) -> (y (T, h, p),
    final state (h, p, n))."""
    t, h, p = x.shape
    n = bm.shape[-1]
    pad = -t % chunk
    xd = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    ad = F.pad(dt * a, (0, 0, 0, pad))             # decay 1 past the end
    bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    c = (t + pad) // chunk
    xd = xd.reshape(c, chunk, h, p)
    bm, cm = bm.reshape(c, chunk, n), cm.reshape(c, chunk, n)
    ad = ad.reshape(c, chunk, h).permute(2, 0, 1)  # (h, c, l)
    acum = torch.cumsum(ad, dim=-1)
    # the diagonal blocks
    decay = torch.exp(segsum(ad))                  # (h, c, l, s)
    cb = ops.einsum("cln,csn->cls", cm, bm)
    y = ops.einsum("hcls,cshp->clhp", decay * cb[None], xd)
    # each chunk's own end state
    to_end = torch.exp(acum[..., -1:] - acum)      # (h, c, l)
    states = ops.einsum("cln,clhp->chpn", bm,
                        xd * to_end.permute(1, 2, 0)[..., None])
    states = torch.cat([torch.zeros_like(states[:1]), states])
    # the states passed between chunks
    across = torch.exp(segsum(F.pad(acum[..., -1], (1, 0))))  # (h, z, c)
    states = ops.einsum("hzc,chpn->zhpn", across, states)
    entering, final = states[:-1], states[-1]
    # each chunk's entering state read out
    y = y + ops.einsum("cln,chpn->clhp", cm, entering) \
        * torch.exp(acum).permute(1, 2, 0)[..., None]
    return y.reshape(c * chunk, h, p)[:t], final


def mixer(p: Dict[str, torch.Tensor], h: torch.Tensor,
          cfg: Mapping[str, Any], ops: _Ops) -> torch.Tensor:
    """One layer's Mamba2 mixer over h (B, T, d), from a zero state."""
    b, t, d = h.shape
    d_in = cfg["mamba_expand"] * d
    heads, g, n = cfg["n_mamba_heads"], cfg["mamba_ngroups"], \
        cfg["mamba_d_state"]
    hp = d_in // heads
    conv_dim = d_in + 2 * g * n
    z, xbc, dtr = torch.split(ops.mm(h, p["w_in"]), [d_in, conv_dim, heads],
                              dim=-1)
    k = p["conv_w"].shape[0]
    xbc = F.conv1d(ops.op(xbc).transpose(1, 2),
                   ops.op(p["conv_w"]).T[:, None, :], p["conv_b"].float(),
                   padding=k - 1, groups=conv_dim)[..., :t].transpose(1, 2)
    xs, bm, cm = torch.split(F.silu(xbc), [d_in, g * n, g * n], dim=-1)
    xs = xs.reshape(b, t, heads, hp)
    bm, cm = bm.reshape(b, t, g, n), cm.reshape(b, t, g, n)
    dt = F.softplus(dtr + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    per = heads // g
    y = torch.empty_like(xs)
    for r in range(b):
        for grp in range(g):
            hs = slice(grp * per, (grp + 1) * per)
            y[r, :, hs], _ = ssd(xs[r, :, hs], dt[r, :, hs], a[hs],
                                 bm[r, :, grp], cm[r, :, grp],
                                 cfg["chunk_size"], ops)
    y = (y + p["D"].float()[:, None] * xs).reshape(b, t, d_in)
    y = (y * F.silu(z)).reshape(b, t, g, d_in // g)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + _GATED_EPS)
    y = y.reshape(b, t, d_in) * p["norm_gate"].float()
    return ops.mm(y, p["w_out"])


def shared(blk, hyb, x, x0, cfg: Mapping[str, Any], ops: _Ops):
    """A hybrid layer's shared-block application and its linear."""
    b, t, d = x.shape
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    eps = cfg["rms_norm_eps"]
    h = rms(torch.cat([x, x0], dim=-1), blk["in_norm"], eps)
    q, k, v = torch.split(ops.mm(h, blk["w_qkv"]), heads * hd, dim=-1)
    q, k, v = (u.reshape(b, t, heads, hd) for u in (q, k, v))
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attention(q, k, v, (hd / 2) ** -0.5, ops).reshape(b, t, heads * hd)
    h = rms(ops.mm(o, blk["wo"]), blk["ff_norm"], eps)
    gu = ops.mm(h, blk["w_gate_up"]) + ops.mm(ops.mm(h, hyb["lora_a"]),
                                              hyb["lora_b"])
    g, u = gu.chunk(2, dim=-1)
    return ops.mm(ops.mm(F.gelu(g) * u, blk["w_down"]), hyb["linear"])


def logits(weights: Mapping[str, Any], cfg: Mapping[str, Any],
           tokens: torch.Tensor, positions: Optional[Sequence[int]] = None,
           prec: Precision = EXACT) -> torch.Tensor:
    """The logits (B, len(positions), V) in fp32 at `positions` (the last
    one where None) of tokens (B, T), every layer from a zero state, on
    the tokens' device, with TF32 off.  The weights may live elsewhere:
    each layer's are moved to the tokens' device as it runs."""
    ops = _Ops(prec)
    eps = cfg["rms_norm_eps"]
    dev = tokens.device
    at = {layer: j for j, layer in enumerate(hybrid_ids(cfg))}
    rows = [tokens.shape[1] - 1] if positions is None else list(positions)

    def on(p):
        return {k: v.to(dev) for k, v in p.items()}

    with no_tf32(), torch.no_grad():
        embed = weights["embed"].to(dev)
        x0 = embed[tokens.long()].float()
        x = x0
        for layer, p in enumerate(weights["layers"]):
            p = on(p)
            h = x
            if layer in at:
                j = at[layer]
                blk = on(weights["blocks"][j % cfg["num_mem_blocks"]])
                h = x + shared(blk, on(weights["hybrid"][j]), x, x0, cfg,
                               ops)
            x = x + mixer(p, rms(h, p["norm"], eps), cfg, ops)
        x = rms(x[:, rows], weights["final_norm"].to(dev), eps)
        return ops.mm(x, embed.T)
