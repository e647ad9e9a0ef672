import repro_torch.kernels.decode_attention.ops  # noqa: F401 — registers "attention"
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, decode_attention_plain)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_ref"]
