"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE [arXiv:2405.04434].

Assignment line lists "MoE 64e top-6" and "2 shared+160 routed"; the real
DeepSeek-V2-Lite has 64 routed experts (top-6) + 2 shared, which we follow
(the 160-routed figure belongs to full V2).  First layer is dense.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    attn_kind="mla", kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    n_experts=64, n_shared_experts=2, experts_per_token=6,
    moe_d_ff=1408, first_dense_layers=1,
    rope_theta=1e4,
)
