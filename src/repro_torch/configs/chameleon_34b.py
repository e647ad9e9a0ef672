"""chameleon-34b [vlm] — early-fusion token-based mixed-modal
[arXiv:2405.09818].  VQ image tokens live in the unified 65536 vocab, so the
language backbone consumes ordinary token ids; the VQ-VAE image tokenizer is
the stubbed frontend.  Chameleon uses qk-norm for stability.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, rope_theta=1e4, modality="vision_stub",
)
