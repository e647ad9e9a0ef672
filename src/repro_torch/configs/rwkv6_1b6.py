"""rwkv6-1.6b [ssm] — "Finch", attention-free, data-dependent decay
[arXiv:2404.05892].  head size 64; channel-mix d_ff=7168."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    attn_kind="none", ssm_kind="rwkv6", ssm_head_dim=64,
)
