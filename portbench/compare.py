"""The comparison that decides `correct`: each compared number against
its limit, printed beside it."""
from __future__ import annotations

import math
from typing import Dict

import torch


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| over the reference's largest |value|; inf where
    the shapes differ or got holds a value that is not finite."""
    if tuple(got.shape) != tuple(ref.shape) or \
            not bool(torch.isfinite(got).all()):
        return math.inf
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit.  A number the limits do not
    name, or a limit no number answers, is refused."""
    if set(numbers) != set(limits):
        raise ValueError(f"compared {sorted(numbers)} but the limits name "
                         f"{sorted(limits)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
