"""Train, prefill and decode steps of the port's models, and the
abstract inputs the dry run walks them on.

The port's counterpart of `repro.launch.steps`.  `make_train_step` takes
autograd gradients of `model.loss` with respect to every parameter leaf
and applies `adamw_update`; the serving steps call the model.

`input_specs(...)` gives a stand-in for every input of a step at a
given input shape: fake tensors (`FakeTensorMode`: shapes, dtypes and
devices, no memory), the port's counterpart of the reference's
`jax.eval_shape` stand-ins.  Every spec of one call shares one
`FakeTensorMode`; `launch/dryrun.py` walks the step inside it.  Decode's
`pos` spec is a 0-d int32 tensor, as the reference's; the dry run calls
the step with the Python int `t - 1` (the models read a shared position
as a host int), which makes the walk read the whole cache, as the
reference's program does whatever `pos` holds.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.shapes import InputShape
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw)


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


# ------------------------------------------------------------- input specs
def _sds(mode: FakeTensorMode, shape, dtype) -> torch.Tensor:
    with mode:
        return torch.empty(shape, dtype=dtype)


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *,
                mode: FakeTensorMode) -> Dict[str, Any]:
    specs = {"tokens": _sds(mode, (batch, seq), torch.int32),
             "labels": _sds(mode, (batch, seq), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = _sds(mode, (batch, cfg.encoder_seq, cfg.d_model),
                               torch.float32)
    return specs


def params_specs(cfg: ModelConfig, model, *, mode: FakeTensorMode):
    with mode:
        return model.init(torch.Generator())


def opt_specs(params) -> AdamWState:
    with next(tree_leaves(params)).fake_mode:
        return init_adamw(params)


def cache_specs(cfg: ModelConfig, model, batch: int, max_len: int, *,
                mode: FakeTensorMode):
    with mode:
        return model.init_cache(batch, max_len, device="cpu")


def input_specs(cfg: ModelConfig, model, shape: InputShape,
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """All abstract inputs needed to walk the step for this shape, made
    under `mode` (a new `FakeTensorMode` if None)."""
    mode = mode or FakeTensorMode()
    b, t = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {"params": params_specs(cfg, model, mode=mode)}
    if shape.kind == "train":
        out["opt_state"] = opt_specs(out["params"])
        out["batch"] = batch_specs(cfg, b, t, mode=mode)
    elif shape.kind == "prefill":
        out["tokens"] = _sds(mode, (b, t), torch.int32)
        out["cache"] = cache_specs(cfg, model, b, t, mode=mode)
        if cfg.is_encoder_decoder:
            out["frames"] = _sds(mode, (b, cfg.encoder_seq, cfg.d_model),
                                 torch.float32)
    else:  # decode
        out["tokens"] = _sds(mode, (b, 1), torch.int32)
        out["cache"] = cache_specs(cfg, model, b, t, mode=mode)
        out["pos"] = _sds(mode, (), torch.int32)
    return out
