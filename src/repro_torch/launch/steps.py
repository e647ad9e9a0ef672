"""Train, prefill and decode steps of the port's models.

The port's counterpart of `repro.launch.steps`.  `make_train_step` takes
autograd gradients of `model.loss` with respect to every parameter leaf
and applies `adamw_update`; the serving steps call the model.  The
reference's abstract input specs (`batch_specs`, `params_specs`,
`cache_specs`, `input_specs`), which only its dry run lowers against,
wait for ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update


def loss_and_grads(model, params, batch: Dict[str, torch.Tensor]):
    """(loss, grads): `model.loss` and its gradient with respect to every
    leaf of `params`, as a tree of the same shape (zeros for a leaf the
    loss does not reach, as `jax.grad` gives).  The leaves require grad
    only for the call."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model, opt_cfg: AdamWConfig = AdamWConfig()):
    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(model, params, batch)
        params, opt_state = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, loss
    return train_step


def make_prefill_step(model, cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        def prefill_step(params, tokens, cache, frames):
            return model.prefill(params, tokens, cache, frames)
    else:
        def prefill_step(params, tokens, cache):
            return model.prefill(params, tokens, cache)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, tokens, cache, pos):
        return model.decode_step(params, tokens, cache, pos)
    return decode_step
