"""The four assigned input shapes and per-(arch, shape) applicability.

The port's copy of `repro.launch.shapes` (plain Python)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long_500k requires sub-quadratic attention: run for SSM/hybrid and for
# the sliding-window dense arch; skip for pure full-attention archs
_LONG_OK_FAMILIES = {"ssm", "hybrid"}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None if runnable, else a skip reason."""
    if shape.name == "long_500k":
        if cfg.family in _LONG_OK_FAMILIES:
            return None
        if cfg.sliding_window > 0:
            return None            # gemma3: local layers O(w), decode O(L)
        return ("full-attention architecture: 500k context has no "
                "sub-quadratic path (skip per assignment)")
    return None
