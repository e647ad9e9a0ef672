from repro_torch.kernels.prefill_attention.prefill_attention import (
    check_operands, head_width, prefill_attention)
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

__all__ = ["check_operands", "head_width", "prefill_attention",
           "prefill_attention_ref"]
