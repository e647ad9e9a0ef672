import repro_torch.kernels.split_matmul.ops  # noqa: F401 — registers "linear"
from repro_torch.kernels.split_matmul.ref import split_matmul_ref
from repro_torch.kernels.split_matmul.split_matmul import (split_matmul,
                                                           split_matmul_plain)

__all__ = ["split_matmul", "split_matmul_plain", "split_matmul_ref"]
