"""Unified architecture configuration for the model pool.

One dataclass covers all six architecture families (dense / moe / ssm /
hybrid / vlm / audio); family-specific fields default to "off".  Each
`repro_torch/configs/<id>.py` instantiates exactly one of these.  The
port's copy of `repro.models.config`, field for field, so one name gives
one configuration, and one graph, in both packages; the training-only
fields (dispatch, remat policy) are kept as data.  `param_count` and
`active_param_count` count parameters as the reference does; `reduced()`
gives the same tiny same-family variant for CPU smoke runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads

    # --- attention ---
    attn_kind: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0          # 0 = full attention
    local_global_ratio: int = 0      # gemma3: N local layers per 1 global

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    first_dense_layers: int = 0      # leading dense layers (deepseek)
    moe_interleave: int = 1          # 1 = every layer MoE; 2 = alternate
    # dispatch tokens within each data shard (scatters stay shard-local)
    moe_local_dispatch: bool = False

    # --- SSM / hybrid ---
    ssm_kind: str = ""               # rwkv6 | mamba2
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0              # zamba2: shared attn block period

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30 s of audio at 50 Hz

    # --- modality frontend (stubbed) ---
    modality: str = "text"           # text | vision_stub | audio_stub

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # activation-checkpoint policy: "full" saves only the inter-layer
    # carry, "dots" also the matmul outputs
    remat_policy: str = "full"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(1, self.n_kv_heads) == 0

    # ---------------------------------------------------------- accounting
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameters (approximate, embeddings included)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared)."""
        return _count_params(self, active_only=True)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes = dict(
            n_layers=n_layers, d_model=d_model, n_heads=heads,
            n_kv_heads=kv, head_dim=d_model // heads,
            d_ff=2 * d_model, vocab_size=vocab,
            encoder_layers=min(self.encoder_layers, n_layers),
            first_dense_layers=min(self.first_dense_layers, 1),
        )
        if self.is_moe:
            changes.update(n_experts=min(self.n_experts, n_experts),
                           experts_per_token=min(self.experts_per_token,
                                                 min(self.n_experts,
                                                     n_experts)),
                           moe_d_ff=d_model)
        if self.kv_lora_rank:
            changes.update(kv_lora_rank=64, qk_rope_head_dim=16,
                           qk_nope_head_dim=d_model // heads,
                           v_head_dim=d_model // heads)
        if self.ssm_kind:
            changes.update(ssm_state=16, ssm_head_dim=32)
        if self.attn_every:
            changes.update(attn_every=2)
        if self.sliding_window:
            changes.update(sliding_window=8)
        if self.local_global_ratio:
            # keep the local:global alternation but fit it in n_layers
            changes.update(local_global_ratio=1,
                           n_layers=max(2, n_layers - n_layers % 2))
        if self.moe_interleave > 1:
            changes.update(n_layers=max(2, n_layers
                                        - n_layers % self.moe_interleave))
        return dataclasses.replace(self, **changes)


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    total = 2 * v * d                     # embed + unembed

    def attn_params() -> int:
        if cfg.attn_kind == "mla":
            r = cfg.kv_lora_rank
            qd = nh * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
            return (d * qd                              # q
                    + d * (r + cfg.qk_rope_head_dim)    # kv down + k_rope
                    + r * nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                    + nh * cfg.v_head_dim * d)          # o
        if cfg.attn_kind == "none":
            return 0
        return d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d

    def ffn_params(layer: int) -> int:
        dense = 3 * d * ff                # SwiGLU
        if not cfg.is_moe or layer < cfg.first_dense_layers \
                or (layer % cfg.moe_interleave) != 0:
            return dense
        experts = cfg.experts_per_token if active_only else cfg.n_experts
        return (3 * d * cfg.moe_d_ff * (experts + cfg.n_shared_experts)
                + d * cfg.n_experts)      # router

    def ssm_params() -> int:
        d_in = cfg.ssm_expand * d
        if cfg.ssm_kind == "rwkv6":
            return 5 * d * d + d * d + 3 * d * ff // 2
        return 2 * d * d_in + d_in * (2 * cfg.ssm_state) + d_in * d

    for layer in range(cfg.n_layers):
        if cfg.ssm_kind and not cfg.attn_every:
            total += ssm_params()
        elif cfg.attn_every:              # hybrid: mamba blocks + shared attn
            total += ssm_params() + d * ff * 2 // cfg.n_layers
        else:
            total += attn_params() + ffn_params(layer)
    if cfg.is_encoder_decoder:
        # encoder layers + decoder cross-attention
        total += cfg.encoder_layers * (attn_params() + 3 * d * ff)
        total += cfg.n_layers * attn_params()
    return total
