"""Unified architecture configuration for the model pool.

One dataclass covers all six architecture families (dense / moe / ssm /
hybrid / vlm / audio); family-specific fields default to "off".  Each
`repro_torch/configs/<id>.py` instantiates exactly one of these.  The
port's copy of `repro.models.config`, field for field, so one name gives
one configuration, and one graph, in both packages; the training-only
fields (dispatch, remat policy) are kept as data.  Parameter counting and
the reduced smoke variants come with the port's models.
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
