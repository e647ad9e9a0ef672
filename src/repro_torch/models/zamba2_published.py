"""Zamba2 as published (arXiv:2411.15242; Zyphra's `config.json` and
`transformers`' `Zamba2ForCausalLM`): the layer equations of the released
models, beside `models/zamba.py`, which keeps the JAX package's
simplified Zamba2 unchanged.

Per token, with x0 the embedding's output:

- `num_hidden_layers` Mamba2 layers; those at `hybrid_layer_ids` are
  hybrid.  Hybrid layer j first runs shared block `j % num_mem_blocks`
  on concat[x, x0] (2 d wide): RMSNorm(2 d); q, k, v of 2 d -> heads x
  `attention_head_dim` (no GQA); RoPE over the whole head at
  `rope_theta`; scores scaled by (head_dim / 2) ** -0.5; o_proj to d;
  RMSNorm(d); then `gelu(g) * u` with [g, u] = h W_gate_up + h A_j B_j,
  A_j B_j hybrid layer j's own rank-`adapter_rank` adapter, and W_down.
  No residual inside the block: its output goes through hybrid layer j's
  own d x d `linear`, and that result t is added to the Mamba layer's
  input only: x <- x + Mamba(RMSNorm(x + t)).
- Each layer's Mamba2 mixer: in_proj d -> [z | xBC | dt], no bias; a
  depthwise causal conv over xBC with bias, then SiLU; `mamba_ngroups`
  groups of B and C, heads [g H / G, (g + 1) H / G) reading group g;
  dt = softplus(dt + dt_bias), no limit (`time_step_limit` null);
  A = -exp(A_log); a D skip; the gated RMSNorm (y silu(z) in fp32,
  normalised over each group's d_inner / G channels, eps 1e-5); out_proj.
- A final RMSNorm and an lm_head tied to the embedding.

Weights and activations are in the layout's dtype (bf16 as published);
the conv, the scan and the gated norm run in fp32.  The mixer's pointwise
work is two hand-written kernels (`kernels/mamba_mixer`), in the precision
and order of the plain expressions they replace: `mamba_conv_silu` takes
the conv, its bias and SiLU and softplus(dt + dt_bias) from the in_proj
output and the conv carry, writing xs, B, C and dt group-major in fp32;
`gated_rms_norm` takes each group's D skip, SiLU(z) gate and gated norm
from that group's scan output, writing bf16 into the out_proj input.  The
SSD core is the hand-written `ssd_chunk_scan`, which takes one B and C
for all the heads of a call, so each layer makes one call per group over
that group's contiguous heads: two calls a layer at G = 2.  A grouped
kernel is later work.  A prefill's shared-block attention is the
hand-written `prefill_attention` (bf16 products, fp32 softmax state), at
every prompt length; a decode step attends through `attention_scores`.
That kernel takes bf16 only, so a float32 layout runs on the CPU alone
(`init` and `init_cache` refuse it on CUDA).  On the CPU the attention is
the kernel's plain version, which holds a sequence's whole (H, T, T) fp32
scores at once (2 GB at 32 heads and 4096 tokens): the CPU runs the
reduced shapes of the tests, not full-size prompts.

The model API is `ServingEngine`'s: `init(generator)`,
`init_cache(batch, max_len, device)`, `prefill(params, tokens, cache)`,
`decode_step(params, tokens, cache, pos)`, and `forward` (every
position's logits from a zero state).  While the profiler runs, each
shared-block application (its linear included) is a
`repro_torch.zamba2.shared` span, each Mamba layer a
`repro_torch.zamba2.mamba` span and each scan call a `repro_torch.ssd`
span; `last_prefill_counts` holds the last prefill's `ssd_calls`,
`shared_applications`, `mixer_fused` (the Mamba layers whose conv and
gated norm ran the `mamba_mixer` kernels: every layer on a card, none on
the CPU) and `prefill_attention`, the attention kernel's launches (one a
hybrid layer on a card, none on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.coexec import resolve_device
from repro_torch.kernels.mamba_mixer import (gated_rms_norm,
                                             mamba_conv_silu, next_carry)
from repro_torch.kernels.prefill_attention import prefill_attention
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.models.layers import (_causal_mask, _normal, apply_rope,
                                       attention_scores, rms_norm)
from repro_torch.models.transformer import DTYPES
from repro_torch.runtime.spans import span

Params = Dict[str, Any]

#: the gated RMSNorm's epsilon (`Zamba2RMSNormGated(..., eps=1e-5)`)
GATED_NORM_EPS = 1e-5

#: the published keys this module implements at one value only
FIXED_KEYS = {"add_bias_linear": False, "hidden_act": "gelu",
              "use_conv_bias": True, "use_mem_rope": True,
              "use_shared_attention_adapter": False,
              "use_shared_mlp_adapter": True, "time_step_limit": None,
              "use_long_context": False}


@dataclasses.dataclass(frozen=True)
class Zamba2Layout:
    """A Zamba2 model's shapes under the published config's key names."""

    name: str
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    hybrid_layer_ids: Tuple[int, ...]
    num_mem_blocks: int
    num_attention_heads: int
    attention_head_dim: int
    intermediate_size: int
    adapter_rank: int
    mamba_d_state: int
    mamba_d_conv: int
    mamba_expand: int
    mamba_headdim: int
    mamba_ngroups: int
    n_mamba_heads: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e4
    time_step_min: float = 1e-3
    time_step_max: float = 0.1
    time_step_floor: float = 1e-4
    dtype: str = "bfloat16"

    is_encoder_decoder: ClassVar[bool] = False

    def __post_init__(self):
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))
        ids = self.hybrid_layer_ids
        checks = [
            (self.num_attention_heads * self.attention_head_dim
             == self.attention_hidden_size,
             "heads x attention_head_dim is not 2 x hidden_size"),
            (self.n_mamba_heads * self.mamba_headdim == self.d_inner,
             "n_mamba_heads x mamba_headdim is not mamba_expand x "
             "hidden_size"),
            (self.n_mamba_heads % self.mamba_ngroups == 0
             and self.d_inner % self.mamba_ngroups == 0,
             "the Mamba heads do not divide into mamba_ngroups groups"),
            (list(ids) == sorted(set(ids)) and all(
                0 <= i < self.num_hidden_layers for i in ids),
             "hybrid_layer_ids are not distinct layers in order"),
            (self.mamba_d_conv >= 2, "mamba_d_conv is under 2"),
            (self.attention_head_dim % 2 == 0, "odd attention_head_dim"),
            (self.dtype in DTYPES, f"dtype {self.dtype!r}"),
        ]
        for ok, why in checks:
            if not ok:
                raise ValueError(f"{self.name}: {why}")

    # ------------------------------------------------------------ widths
    @property
    def attention_hidden_size(self) -> int:
        return 2 * self.hidden_size

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.mamba_ngroups * self.mamba_d_state

    @property
    def in_proj_width(self) -> int:
        """[z | xBC | dt]"""
        return self.d_inner + self.conv_dim + self.n_mamba_heads

    @property
    def n_hybrid(self) -> int:
        return len(self.hybrid_layer_ids)

    @property
    def attention_scale(self) -> float:
        """`Zamba2Attention.scaling`: (head_dim / 2) ** -0.5."""
        return (self.attention_head_dim / 2) ** -0.5

    # ------------------------------------------------------------ builds
    @classmethod
    def from_hf(cls, doc: Mapping[str, Any],
                name: Optional[str] = None) -> "Zamba2Layout":
        """The layout of a published `config.json` (keys beyond these are
        ignored).  Refuses a config that asks for what this module does
        not implement (`FIXED_KEYS`) or whose derived widths disagree."""
        for key, want in FIXED_KEYS.items():
            if key in doc and doc[key] != want:
                raise ValueError(f"{key} = {doc[key]!r}: only {want!r} is "
                                 f"implemented")
        kinds = doc.get("layers_block_type")
        ids = [i for i, k in enumerate(kinds) if k == "hybrid"] if kinds \
            else list(doc["hybrid_layer_ids"])
        derived = {
            "hybrid_layer_ids": (list(doc.get("hybrid_layer_ids", ids)),
                                 ids),
            "num_key_value_heads": (doc.get("num_key_value_heads",
                                            doc["num_attention_heads"]),
                                    doc["num_attention_heads"]),
            "attention_hidden_size": (doc.get("attention_hidden_size",
                                              2 * doc["hidden_size"]),
                                      2 * doc["hidden_size"]),
            "kv_channels": (doc.get("kv_channels", doc["hidden_size"]
                                    // doc["num_attention_heads"]),
                            doc["hidden_size"] // doc["num_attention_heads"]),
            "ffn_hidden_size": (doc.get("ffn_hidden_size",
                                        doc["intermediate_size"]),
                                doc["intermediate_size"]),
        }
        for key, (got, want) in derived.items():
            if got != want:
                raise ValueError(f"{key} = {got!r}; the other keys give "
                                 f"{want!r}")
        if kinds is not None and len(kinds) != doc["num_hidden_layers"]:
            raise ValueError("layers_block_type does not name every layer")
        return cls(
            name=name or doc.get("name", "zamba2"),
            vocab_size=doc["vocab_size"], hidden_size=doc["hidden_size"],
            num_hidden_layers=doc["num_hidden_layers"],
            hybrid_layer_ids=tuple(ids),
            num_mem_blocks=doc["num_mem_blocks"],
            num_attention_heads=doc["num_attention_heads"],
            attention_head_dim=doc.get("attention_head_dim",
                                       2 * doc["hidden_size"]
                                       // doc["num_attention_heads"]),
            intermediate_size=doc["intermediate_size"],
            adapter_rank=doc["adapter_rank"],
            mamba_d_state=doc["mamba_d_state"],
            mamba_d_conv=doc["mamba_d_conv"],
            mamba_expand=doc["mamba_expand"],
            mamba_headdim=doc["mamba_headdim"],
            mamba_ngroups=doc["mamba_ngroups"],
            n_mamba_heads=doc["n_mamba_heads"],
            rms_norm_eps=doc["rms_norm_eps"], rope_theta=doc["rope_theta"],
            time_step_min=doc["time_step_min"],
            time_step_max=doc["time_step_max"],
            time_step_floor=doc["time_step_floor"],
            dtype=doc.get("dtype", "bfloat16"))

    def reduced(self) -> "Zamba2Layout":
        """A tiny variant of the same equations for CPU runs: d = 64, four
        heads of 32 over the 128-wide concat, two groups, two blocks,
        adapter rank 8, seven layers of which 1, 3 and 4 are hybrid."""
        return dataclasses.replace(
            self, name=f"{self.name}-reduced", vocab_size=512,
            hidden_size=64, num_hidden_layers=7, hybrid_layer_ids=(1, 3, 4),
            num_mem_blocks=2, num_attention_heads=4, attention_head_dim=32,
            intermediate_size=128, adapter_rank=8, mamba_d_state=16,
            mamba_headdim=16, mamba_ngroups=2, n_mamba_heads=8)

    def param_count(self) -> int:
        d, f, r = self.hidden_size, self.intermediate_size, self.adapter_rank
        mixer = (d * self.in_proj_width + self.mamba_d_conv * self.conv_dim
                 + self.conv_dim + 3 * self.n_mamba_heads + self.d_inner
                 + self.d_inner * d + d)
        block = (2 * d + 2 * d * 3 * self.attention_hidden_size
                 + self.attention_hidden_size * d + d + d * 2 * f + f * d)
        hybrid = d * d + d * r + r * 2 * f
        return (self.vocab_size * d + d + self.num_hidden_layers * mixer
                + self.num_mem_blocks * block + self.n_hybrid * hybrid)


def _dt_bias(generator: torch.Generator, cfg: Zamba2Layout) -> torch.Tensor:
    """`Zamba2PreTrainedModel._init_weights`: dt log-uniform in
    [time_step_min, time_step_max], floored at time_step_floor, and the
    bias its inverse softplus."""
    u = torch.rand((cfg.n_mamba_heads,), generator=generator,
                   device=generator.device, dtype=torch.float32)
    lo, hi = math.log(cfg.time_step_min), math.log(cfg.time_step_max)
    dt = torch.exp(u * (hi - lo) + lo).clamp(min=cfg.time_step_floor)
    return dt + torch.log(-torch.expm1(-dt))


def _refuse_on_cuda(device, dtype: torch.dtype) -> None:
    """Raise where `device` is CUDA and `dtype` not bf16: a prefill
    attends through the `prefill_attention` kernel, which takes bf16
    only.  float32 runs on the CPU, through the kernel's plain version."""
    if torch.device("cuda" if device is None else device).type == "cuda" \
            and dtype != torch.bfloat16:
        raise ValueError(f"the published Zamba2 runs bfloat16 only on "
                         f"CUDA (its prefill attention kernel's one "
                         f"dtype), not {dtype}; run {dtype} on the CPU")


class Zamba2PublishedModel:
    """The published Zamba2 on the device the caller chose: bf16 on
    CUDA, bf16 or float32 on the CPU."""

    pad_aware = False

    def __init__(self, cfg: Zamba2Layout):
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.scale = cfg.attention_scale
        self.hybrid_at = {layer: j for j, layer in
                          enumerate(cfg.hybrid_layer_ids)}
        self.last_prefill_counts: Dict[str, int] = {}
        self._tally: Dict[str, int] = {}

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Params:
        """Seeded weights on the generator's device (a CUDA one takes
        bf16 only, `_refuse_on_cuda`): A_log = log(1..H),
        D = 1 and dt_bias as the published `_init_weights` sets them
        (fp32); norms 1; every other weight and the conv bias N(0,
        1/fan_in), the embedding at the tied lm_head's fan-in d."""
        cfg, dt, dev = self.cfg, self.dtype, generator.device
        _refuse_on_cuda(dev, dt)
        d, f, r = cfg.hidden_size, cfg.intermediate_size, cfg.adapter_rank
        wide = cfg.attention_hidden_size
        k = cfg.mamba_d_conv

        def normal(shape, fan_in):
            return _normal(generator, shape, dt, 1.0 / math.sqrt(fan_in))

        def ones(n):
            return torch.ones((n,), dtype=dt, device=dev)

        def f32(x):
            return x.to(device=dev, dtype=torch.float32)

        params: Params = {"embed": normal((cfg.vocab_size, d), d)}
        params["blocks"] = [{
            "in_norm": ones(wide),
            "w_qkv": normal((wide, 3 * wide), wide),
            "wo": normal((wide, d), wide),
            "ff_norm": ones(d),
            "w_gate_up": normal((d, 2 * f), d),
            "w_down": normal((f, d), f),
        } for _ in range(cfg.num_mem_blocks)]
        params["hybrid"] = [{
            "lora_a": normal((d, r), d),
            "lora_b": normal((r, 2 * f), r),
            "linear": normal((d, d), d),
        } for _ in range(cfg.n_hybrid)]
        params["layers"] = [{
            "norm": ones(d),
            "w_in": normal((d, cfg.in_proj_width), d),
            "conv_w": normal((k, cfg.conv_dim), k),
            "conv_b": normal((cfg.conv_dim,), k),
            "dt_bias": _dt_bias(generator, cfg),
            "A_log": f32(torch.log(torch.arange(
                1, cfg.n_mamba_heads + 1, dtype=torch.float32))),
            "D": f32(torch.ones(cfg.n_mamba_heads)),
            "norm_gate": ones(cfg.d_inner),
            "w_out": normal((cfg.d_inner, d), cfg.d_inner),
        } for _ in range(cfg.num_hidden_layers)]
        params["final_norm"] = ones(d)
        return params

    def init_cache(self, batch: int, max_len: int,
                   device: Union[str, torch.device, None] = None):
        """Zeroed caches on `device` (CUDA unless given; there bf16
        only, as `init`): a (k, v) pair of
        (batch, max_len, heads, head_dim) per hybrid layer, and per layer
        an fp32 SSM state (batch, H, P, N) and a conv carry (batch, K - 1,
        conv_dim) in the model dtype."""
        cfg = self.cfg
        _refuse_on_cuda(device, self.dtype)
        device = resolve_device(device)
        kv = (batch, max_len, cfg.num_attention_heads,
              cfg.attention_head_dim)
        state = (batch, cfg.n_mamba_heads, cfg.mamba_headdim,
                 cfg.mamba_d_state)
        carry = (batch, cfg.mamba_d_conv - 1, cfg.conv_dim)

        def zeros(shape, dtype, n):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(n)]

        return {"k": zeros(kv, self.dtype, cfg.n_hybrid),
                "v": zeros(kv, self.dtype, cfg.n_hybrid),
                "ssm": zeros(state, torch.float32, cfg.num_hidden_layers),
                "conv": zeros(carry, self.dtype, cfg.num_hidden_layers)}

    # -------------------------------------------------------------- mixer
    def _count(self, key: str) -> None:
        self._tally[key] = self._tally.get(key, 0) + 1

    def _scan(self, xs, bmat, cmat, dt, a, state):
        """The SSD scan of every head, one `ssd_chunk_scan` call a group.
        xs (B, T, G, H / G, P), bmat and cmat (B, T, G, N), dt (B, T, G,
        H / G) fp32, views of group-major storage, so that each group's
        slices are dense; a (H,); state (B, H, P, N).  Returns (each
        group's y (B, T, H / G, P), final state (B, H, P, N)), fp32."""
        per = self.cfg.n_mamba_heads // self.cfg.mamba_ngroups
        ys, finals = [], []
        for g in range(self.cfg.mamba_ngroups):
            hs = slice(g * per, (g + 1) * per)
            with span("repro_torch.ssd"):
                sf, y = ssd_chunk_scan(
                    xs[:, :, g].contiguous(), bmat[:, :, g].contiguous(),
                    cmat[:, :, g].contiguous(), dt[:, :, g].contiguous(),
                    a[hs].contiguous(), state[:, hs].contiguous())
            self._count("ssd_calls")
            ys.append(y)
            finals.append(sf)
        return ys, torch.cat(finals, dim=1)

    def _mixer(self, p: Params, h: torch.Tensor, state: torch.Tensor,
               carry: torch.Tensor):
        """The Mamba2 mixer over h (B, T, d) from `state` and the conv
        `carry`.  Returns (out (B, T, d), final state, new carry).  The
        conv and the gated norm are the `mamba_mixer` kernels (their plain
        versions on the CPU); a layer whose conv and norms all launched
        counts in `mixer_fused`."""
        cfg = self.cfg
        b, t, _ = h.shape
        g = cfg.mamba_ngroups
        dg, hg = cfg.d_inner // g, cfg.n_mamba_heads // g
        launched = (mamba_conv_silu.launches, gated_rms_norm.launches)
        z, xbc, dt_raw = torch.split(
            h @ p["w_in"], [cfg.d_inner, cfg.conv_dim, cfg.n_mamba_heads],
            dim=-1)
        xs, bmat, cmat, dt = mamba_conv_silu(
            xbc, carry, p["conv_w"], p["conv_b"], dt_raw, p["dt_bias"],
            ngroups=g, headdim=cfg.mamba_headdim)
        ys, final = self._scan(xs.movedim(0, 2), bmat.movedim(0, 2),
                               cmat.movedim(0, 2), dt.movedim(0, 2),
                               -torch.exp(p["A_log"]), state)
        y = torch.empty((b, t, cfg.d_inner), dtype=h.dtype, device=h.device)
        for i, yg in enumerate(ys):
            cols, heads = slice(i * dg, (i + 1) * dg), slice(i * hg,
                                                             (i + 1) * hg)
            gated_rms_norm(yg, xs[i], z[..., cols], p["D"][heads],
                           p["norm_gate"][cols], y[..., cols],
                           eps=GATED_NORM_EPS)
        if (mamba_conv_silu.launches - launched[0],
                gated_rms_norm.launches - launched[1]) == (1, g):
            self._count("mixer_fused")
        return y @ p["w_out"], final, next_carry(carry, xbc)

    # -------------------------------------------------------- shared block
    def _attend(self, q, k, v, pos: int) -> torch.Tensor:
        """Causal attention of the T queries at positions [pos, pos + T)
        over the keys [0, pos + T): a prefill from an empty cache through
        the `prefill_attention` kernel (its plain version on the CPU), a
        decode step through `attention_scores`."""
        if pos == 0:
            return prefill_attention(q, k, v, scale=self.scale)
        t, s = q.shape[1], k.shape[1]
        mask = _causal_mask(t, s, q_offset=pos, device=q.device)
        return attention_scores(q, k, v, mask, scale=self.scale)

    def _mlp(self, blk: Params, hyb: Params, h: torch.Tensor
             ) -> torch.Tensor:
        """gelu(g) * u, [g, u] = h W_gate_up + h A_j B_j, then W_down."""
        gu = h @ blk["w_gate_up"] + (h @ hyb["lora_a"]) @ hyb["lora_b"]
        gate, up = gu.chunk(2, dim=-1)
        return (F.gelu(gate) * up) @ blk["w_down"]

    def _shared(self, params: Params, j: int, x: torch.Tensor,
                x0: torch.Tensor, cache, pos: int) -> torch.Tensor:
        """Hybrid layer j's shared-block application and its linear: the
        t added to the Mamba layer's input.  Writes the layer's keys and
        values at [pos, pos + T)."""
        cfg = self.cfg
        blk = params["blocks"][j % cfg.num_mem_blocks]
        hyb = params["hybrid"][j]
        b, t, _ = x.shape
        heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
        h = rms_norm(torch.cat([x, x0], dim=-1), blk["in_norm"],
                     cfg.rms_norm_eps)
        q, k, v = (h @ blk["w_qkv"]).reshape(b, t, 3, heads, hd).unbind(2)
        positions = torch.arange(pos, pos + t, device=x.device).expand(b, t)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        cache["k"][j][:, pos:pos + t] = k
        cache["v"][j][:, pos:pos + t] = v
        if pos:
            k, v = cache["k"][j][:, :pos + t], cache["v"][j][:, :pos + t]
        o = self._attend(q, k, v, pos).reshape(b, t, heads * hd) @ blk["wo"]
        h = rms_norm(o, blk["ff_norm"], cfg.rms_norm_eps)
        return self._mlp(blk, hyb, h) @ hyb["linear"]

    # --------------------------------------------------------------- runs
    def _run(self, params: Params, tokens: torch.Tensor, cache,
             pos: int) -> torch.Tensor:
        """Every layer over tokens (B, T) at positions [pos, pos + T),
        writing the caches in place; returns the final-normed hidden
        states (B, T, d)."""
        cfg = self.cfg
        self._tally = {"ssd_calls": 0, "shared_applications": 0,
                       "mixer_fused": 0}
        x0 = params["embed"][tokens.long()]
        x = x0
        for layer, p in enumerate(params["layers"]):
            j = self.hybrid_at.get(layer)
            h = x
            if j is not None:
                with span("repro_torch.zamba2.shared"):
                    h = x + self._shared(params, j, x, x0, cache, pos)
                self._count("shared_applications")
            with span("repro_torch.zamba2.mamba"):
                y, state, carry = self._mixer(
                    p, rms_norm(h, p["norm"], cfg.rms_norm_eps),
                    cache["ssm"][layer], cache["conv"][layer])
                cache["ssm"][layer].copy_(state)
                cache["conv"][layer].copy_(carry)
                x = x + y
                # the new carry views the in_proj output: let both go
                # before the next layer allocates its own
                del y, state, carry
        return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """The lm_head, tied to the embedding."""
        return h @ params["embed"].T

    def prefill(self, params: Params, tokens: torch.Tensor, cache):
        """tokens (B, T) from an empty cache: writes KV positions [0, T)
        of every hybrid layer and every layer's state and conv carry, in
        place.  Returns (last-position logits (B, V), cache)."""
        launched = prefill_attention.launches
        h = self._run(params, tokens, cache, 0)
        self.last_prefill_counts = dict(
            self._tally,
            prefill_attention=prefill_attention.launches - launched)
        return self._logits(params, h[:, -1]), cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: Union[int, torch.Tensor]):
        """tokens (B, 1) at the shared position `pos` (an int or a 0-d
        tensor).  Writes the cache in place; returns (logits (B, V),
        cache)."""
        h = self._run(params, tokens, cache, int(pos))
        return self._logits(params, h[:, 0]), cache

    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) -> (logits (B, T, V), aux loss 0), from a zero
        state."""
        b, t = tokens.shape
        cache = self.init_cache(b, t, device=tokens.device)
        h = self._run(params, tokens, cache, 0)
        return self._logits(params, h), torch.zeros(
            (), dtype=torch.float32, device=h.device)
