"""AdamW with a cosine schedule after a linear warmup, on torch tensors.

The port's counterpart of `repro.optim.adamw`, step for step: a global
gradient-norm clip, bias-corrected first and second moments kept in
fp32 whatever the parameter dtype, weight decay on every leaf, and the
update taken in fp32 and cast back to each leaf's dtype.  Parameters are
the port's trees (nested dicts and lists of tensors); the moments are
trees of the same shape.  The step count and the schedule stay 0-d
tensors on the parameters' device, so a step makes no host sync.

`adamw_update` updates the parameters and the moments in place (under
`torch.no_grad()`, one leaf at a time, so its fp32 temporaries are one
leaf's) and returns them with the new step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: Any
    nu: Any


def init_adamw(params) -> AdamWState:
    """Zero fp32 moments shaped as `params`, and step 0."""
    first = next(tree_leaves(params))

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=zeros(), nu=zeros())


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (a 0-d int tensor): linear warmup, then a
    cosine from lr to 0.1 x lr at `total_steps`; fp32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads,
                 state: AdamWState) -> Tuple[Any, AdamWState]:
    """One AdamW step of `params` along `grads` (a tree of the same shape,
    any float dtype).  Updates `params` and the moments in place; returns
    (params, the new state)."""
    leaves = list(tree_leaves(params))
    g_leaves = list(tree_leaves(grads))
    # global-norm clip, the squares summed leaf by leaf in fp32
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in g_leaves))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    step = state.step + 1
    b1, b2 = cfg.betas
    lr = _schedule(cfg, step)
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    for p, g, m, v in zip(leaves, g_leaves, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
