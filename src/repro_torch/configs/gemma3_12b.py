"""gemma3-12b [dense] — 5:1 local:global sliding-window, 262k vocab
[hf:google/gemma-3-1b-pt].  head_dim=256 (not d_model/n_heads); local layers
use a 1024-token window; qk-norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab_size=262144, head_dim=256,
    qk_norm=True, sliding_window=1024, local_global_ratio=5,
    rope_theta=1e6,
)
