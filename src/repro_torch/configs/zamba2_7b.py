"""zamba2-7b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242].  81 layers; shared attn applied every 9 layers (the
reference interleaves 2 shared blocks), ssm_state=64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_kind="mamba2", ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=9,
)
