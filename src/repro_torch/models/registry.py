"""Model names: the architecture ids, their CLI aliases, and their configs.

The port's copy of the name tables of `repro.models.registry`; a config
resolves from `repro_torch.configs.<arch>`.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

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
