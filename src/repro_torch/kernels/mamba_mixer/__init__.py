from repro_torch.kernels.mamba_mixer.mamba_mixer import (
    gated_rms_norm, mamba_conv_silu, next_carry)
from repro_torch.kernels.mamba_mixer.ref import (gated_rms_norm_ref,
                                                 mamba_conv_silu_ref)

__all__ = ["gated_rms_norm", "gated_rms_norm_ref", "mamba_conv_silu",
           "mamba_conv_silu_ref", "next_carry"]
