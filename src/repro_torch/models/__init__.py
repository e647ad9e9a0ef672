"""The port's models: configurations, their name tables, the decoder-only
transformers (GQA or MLA attention, dense or MoE feed-forward), the Zamba2
hybrid, RWKV6 and the Whisper encoder-decoder.

The port's copies of `repro.models.config`, `registry`, `layers`, `flash`,
`mla`, `moe`, `transformer`, `zamba`, `rwkv`, `ssm` and `encdec`
(PyTorch), plus `weights.params_from_numpy`, which takes the
reference's parameter pytree, and its inverse `params_to_numpy`.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.registry import (ALIASES, ARCH_IDS, build, build_model,
                                         get_config)
from repro_torch.models.rwkv import RWKVModel
from repro_torch.models.transformer import TransformerModel
from repro_torch.models.weights import (params_from_numpy, params_to_numpy,
                                        params_to_reference)
from repro_torch.models.zamba import ZambaModel

__all__ = ["ModelConfig", "ALIASES", "ARCH_IDS", "EncDecModel", "RWKVModel",
           "TransformerModel", "ZambaModel", "build", "build_model", "get_config",
           "params_from_numpy", "params_to_numpy", "params_to_reference"]
