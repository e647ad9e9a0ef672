"""Model registry: the architecture ids, their CLI aliases, their configs,
and ModelConfig -> model object.

The port's copy of `repro.models.registry`; a config resolves from
`repro_torch.configs.<arch>`.  The model API (duck-typed, as the
reference's):
    init(generator) -> params
    loss(params, batch) -> scalar           batch: tokens/labels
    init_cache(batch, max_len, device) -> cache
    prefill(params, tokens, cache[, start]) -> (logits, cache)
    prefill(params, tokens, cache, frames) -> (logits, cache)  (Whisper)
    decode_step(params, tokens, cache, pos[, start]) -> (logits, cache)

Every family of the reference builds: the decoder-only transformers (GQA
or MLA attention, dense or MoE feed-forward), the Zamba2 hybrid, RWKV6
and the Whisper encoder-decoder.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.rwkv import RWKVModel
from repro_torch.models.transformer import TransformerModel
from repro_torch.models.zamba import ZambaModel

ARCH_IDS: List[str] = [
    "deepseek_v2_lite",
    "chameleon_34b",
    "llama3_405b",
    "gemma3_12b",
    "llama4_scout",
    "whisper_large_v3",
    "codeqwen15_7b",
    "rwkv6_1b6",
    "zamba2_7b",
    "qwen25_32b",
]

# CLI aliases (either form resolves)
ALIASES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "chameleon-34b": "chameleon_34b",
    "llama3-405b": "llama3_405b",
    "gemma3-12b": "gemma3_12b",
    "llama4-scout-17b-a16e": "llama4_scout",
    "whisper-large-v3": "whisper_large_v3",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "zamba2-7b": "zamba2_7b",
    "qwen2.5-32b": "qwen25_32b",
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def build_model(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return EncDecModel(cfg)
    if cfg.ssm_kind == "rwkv6":
        return RWKVModel(cfg)
    if cfg.attn_every:
        return ZambaModel(cfg)
    return TransformerModel(cfg)


def build(arch: str):
    cfg = get_config(arch)
    return cfg, build_model(cfg)
