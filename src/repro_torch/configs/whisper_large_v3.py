"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed to
frame embeddings [arXiv:2212.04356].  32 encoder + 32 decoder layers, MHA
(kv=20).  decode_32k / long_500k exceed the model's 448-token target spec
but are lowered mechanically."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    is_encoder_decoder=True, encoder_layers=32, encoder_seq=1500,
    modality="audio_stub",
)
