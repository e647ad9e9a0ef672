"""ViT-Base-32, the paper's running example workload (arXiv:2010.11929),
as linear-op shapes (L=50 tokens, d=768, mlp 3072): the port's copy of
`repro.configs.vit_base_32`."""
from repro_torch.core.types import LinearOp

# the paper's running-example op: (50, 768) @ (768, 3072)
MLP_UP = LinearOp(L=50, C_in=768, C_out=3072)
MLP_DOWN = LinearOp(L=50, C_in=3072, C_out=768)
QKV = LinearOp(L=50, C_in=768, C_out=2304)
PROJ = LinearOp(L=50, C_in=768, C_out=768)
ALL_OPS = [QKV, PROJ, MLP_UP, MLP_DOWN]
