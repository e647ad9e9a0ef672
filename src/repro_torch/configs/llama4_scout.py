"""llama4-scout-17b-a16e [moe] — 16 routed experts top-1 + 1 shared expert
on every layer, early-fusion vision (stub)
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    n_experts=16, n_shared_experts=1, experts_per_token=1,
    moe_d_ff=8192, moe_interleave=1,
    rope_theta=5e5, modality="vision_stub",
)
