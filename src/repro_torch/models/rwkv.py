"""RWKV6 ("Finch") decoder stack — attention-free, O(1)-state decode.

The port's counterpart of `repro.models.rwkv`.  Each layer: an RMS norm,
the RWKV6 time mix (`models/ssm.py` `rwkv6_mix`), a residual add, an RMS
norm, the channel-mix FFN, a residual add.  The paper's channel
partitioning applies to the r/k/v/g/o projections and the channel-mix FFN
(plain `@` products); the WKV recurrence itself is sequential and never
split.  No layer reaches a hand-written kernel: neither WKV branch is a
Pallas kernel in the reference.

The reference stacks the layers for a scan; PyTorch runs eagerly, so the
port keeps one param dict per layer (`params["blocks"][l]`) and one state
per layer in the cache (`cache["wkv"][l]` fp32, `cache["x_tm"][l]` and
`cache["x_cm"][l]` in the model dtype: the time and channel mixes' token
shift carries); `models/weights.py` turns the reference's stacked pytree
into this layout.  Prefill and decode write the cache in place.  The
recurrent state carries the position, so `decode_step` ignores `pos`.  The
model is neither pad-aware nor per-slot, as the reference's is not: the
continuous scheduler refuses it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.coexec import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.ssm import (init_rwkv6, init_rwkv_channel_mix,
                                    rwkv6_mix, rwkv6_state_shapes,
                                    rwkv_channel_mix)
from repro_torch.models.transformer import DTYPES

Params = Dict[str, Any]


class RWKVModel:
    """The reference's model API (`init`, `forward`, `loss`, `init_cache`,
    `prefill`, `decode_step`) on the device the caller chose."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]

    def init(self, generator: torch.Generator) -> Params:
        """Seeded weights with the reference's shapes and scales, drawn
        from `generator` on its device."""
        cfg, dt, dev = self.cfg, self.dtype, generator.device

        def ones():
            return torch.ones((cfg.d_model,), dtype=dt, device=dev)

        return {
            "embed": torch.randn((cfg.vocab_size, cfg.d_model),
                                 generator=generator, device=dev,
                                 dtype=dt).mul_(0.02),
            "unembed": torch.randn((cfg.d_model, cfg.vocab_size),
                                   generator=generator, device=dev,
                                   dtype=dt).mul_(1.0 / math.sqrt(
                                       cfg.d_model)),
            "ln_f": ones(),
            "blocks": [{"ln1": ones(), "ln2": ones(),
                        "tm": init_rwkv6(generator, cfg, dt),
                        "cm": init_rwkv_channel_mix(generator, cfg, dt)}
                       for _ in range(cfg.n_layers)],
        }

    def init_cache(self, batch: int, max_len: int = 0,
                   device: Union[str, torch.device, None] = None):
        """Zeroed per-layer states on `device` (CUDA unless given): the WKV
        state (batch, H, hd, hd) in fp32 and the two token-shift carries
        (batch, d_model) in the model dtype.  `max_len` is unused: the
        state does not grow with the sequence."""
        device = resolve_device(device)
        wkv_shape, xs_shape = rwkv6_state_shapes(self.cfg, batch)
        layers = range(self.cfg.n_layers)

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in layers]

        return {"wkv": zeros(wkv_shape, torch.float32),
                "x_tm": zeros(xs_shape, self.dtype),
                "x_cm": zeros(xs_shape, self.dtype)}

    def _stack_forward(self, params: Params, x: torch.Tensor,
                       cache, write: bool = True) -> torch.Tensor:
        """Every layer in order from the cache's states, with `write` each
        layer's new states written into the cache in place (`forward`
        keeps none: an in-place write would overwrite what autograd
        saved); then the final norm."""
        cfg = self.cfg
        for p, wkv, x_tm, x_cm in zip(params["blocks"], cache["wkv"],
                                      cache["x_tm"], cache["x_cm"]):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            h, wkv2, x_tm2 = rwkv6_mix(p["tm"], h, cfg, wkv, x_tm)
            x = x + h
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            h, x_cm2 = rwkv_channel_mix(p["cm"], h, x_cm)
            if write:
                wkv.copy_(wkv2)
                x_tm.copy_(x_tm2)
                x_cm.copy_(x_cm2)
            x = x + h
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) -> (logits (B, T, V), aux loss 0), every layer
        from a zero state."""
        x = params["embed"][tokens.long()]
        cache = self.init_cache(x.shape[0], device=x.device)
        x = self._stack_forward(params, x, cache, write=False)
        return x @ params["unembed"], torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL in fp32 (`launch.steps.make_train_step`
        differentiates it)."""
        logits, _ = self.forward(params, batch["tokens"])
        logp = F.log_softmax(logits.float(), dim=-1)
        labels = batch["labels"].long()
        return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()

    def prefill(self, params: Params, tokens: torch.Tensor, cache):
        """Full-sequence pass from the cache's states, which it advances in
        place.  Returns (last-position logits (B, V), cache)."""
        x = self._stack_forward(params, params["embed"][tokens.long()],
                                cache)
        return x[:, -1, :] @ params["unembed"], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: Union[int, torch.Tensor]):
        """tokens (B, 1); `pos` is ignored (the recurrent state carries the
        position).  Advances the cache in place; returns (logits (B, V),
        cache)."""
        del pos
        x = self._stack_forward(params, params["embed"][tokens.long()],
                                cache)
        return x[:, 0, :] @ params["unembed"], cache
