"""Zamba2-style hybrid: a Mamba2 backbone and one weight-SHARED attention
block applied every `attn_every` layers (arXiv:2411.15242).

The port's counterpart of `repro.models.zamba`, with the reference's
simplifications (no per-application LoRA adapters; the shared block reads
the residual stream, not concat[x, x0]).  Layer program: n_groups =
n_layers // attn_every; each group is one shared-attention application
followed by `attn_every` Mamba2 layers, and the shared block keeps one KV
cache per application.

The reference stacks each group's Mamba2 layers for a scan; PyTorch runs
eagerly, so the port keeps one param dict per layer
(`params["mamba"][g][k]`) and one state per layer in the cache
(`cache["ssm"][g][k]`, `cache["conv"][g][k]`), in the reference's order;
`models/weights.py` turns the reference's stacked pytree into this
layout.  Prefill and decode write the cache in place.

Every Mamba2 layer's SSD core is one `ssd_chunk_scan` call
(`models/ssm.py`): on the card, prefill launches the chunk kernels and a
decode step the decode kernel, once per layer each.  The model is neither
pad-aware nor per-slot: the reference's is not, so a left-padded prompt
runs through the SSM as it does there, and the continuous scheduler
refuses it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.coexec import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnSpec, attention_decode,
                                       attention_full, attention_prefill,
                                       init_attention, init_mlp, mlp,
                                       rms_norm)
from repro_torch.models.ssm import (init_mamba2, mamba2_mix,
                                    mamba2_state_shapes)
from repro_torch.models.transformer import DTYPES

Params = Dict[str, Any]


class ZambaModel:
    """The reference's model API (`init`, `forward`, `loss`, `init_cache`,
    `prefill`, `decode_step`) on the device the caller chose."""

    def __init__(self, cfg: ModelConfig):
        if not (cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0):
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.dtype = DTYPES[cfg.dtype]
        self.spec = AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)

    # ------------------------------------------------------------- params
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
            "shared_attn": {
                "ln1": ones(), "ln2": ones(),
                "attn": init_attention(generator, cfg.d_model, self.spec, dt),
                "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dt),
            },
            "mamba": [[{"ln": ones(),
                        "mixer": init_mamba2(generator, cfg, dt)}
                       for _ in range(cfg.attn_every)]
                      for _ in range(self.n_groups)],
        }

    def init_cache(self, batch: int, max_len: int,
                   device: Union[str, torch.device, None] = None):
        """Zeroed caches on `device` (CUDA unless given): one (k, v) pair
        of (batch, max_len, kv, hd) per shared-attention application, and
        per Mamba2 layer an fp32 SSM state and a conv carry in the model
        dtype."""
        cfg = self.cfg
        device = resolve_device(device)
        ssm_shape, conv_shape = mamba2_state_shapes(cfg, batch)
        kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        def per_layer(shape, dtype):
            return [[zeros(shape, dtype) for _ in range(cfg.attn_every)]
                    for _ in range(self.n_groups)]

        return {"attn_k": [zeros(kv_shape, self.dtype)
                           for _ in range(self.n_groups)],
                "attn_v": [zeros(kv_shape, self.dtype)
                           for _ in range(self.n_groups)],
                "ssm": per_layer(ssm_shape, torch.float32),
                "conv": per_layer(conv_shape, self.dtype)}

    # -------------------------------------------------------------- blocks
    def _mamba_group(self, group: List[Params], x: torch.Tensor,
                     ssm: List[torch.Tensor], conv: List[torch.Tensor]
                     ) -> torch.Tensor:
        """The group's Mamba2 layers in order; each layer's final state
        and conv carry are written into `ssm[k]` and `conv[k]`."""
        for p, s, c in zip(group, ssm, conv):
            h = rms_norm(x, p["ln"], self.cfg.norm_eps)
            h, s2, c2 = mamba2_mix(p["mixer"], h, self.cfg, s, c)
            s.copy_(s2)
            c.copy_(c2)
            x = x + h
        return x

    def _shared_attn(self, params: Params, x: torch.Tensor, mode: str,
                     g: int = 0, cache=None, pos=None) -> torch.Tensor:
        """The shared block; "prefill" writes positions [0, T) of
        application g's KV cache, "decode" position `pos`."""
        cfg = self.cfg
        p = params["shared_attn"]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if mode == "full":
            h = attention_full(p["attn"], h, self.spec)
        elif mode == "prefill":
            h, (k, v) = attention_prefill(p["attn"], h, self.spec)
            t = x.shape[1]
            cache["attn_k"][g][:, :t] = k.to(self.dtype)
            cache["attn_v"][g][:, :t] = v.to(self.dtype)
        else:
            h, _, _ = attention_decode(p["attn"], h, self.spec,
                                       cache["attn_k"][g],
                                       cache["attn_v"][g], pos)
        x = x + h
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp(p["mlp"], h)

    def _run(self, params: Params, x: torch.Tensor, cache, mode: str,
             pos=None) -> torch.Tensor:
        for g in range(self.n_groups):
            x = self._shared_attn(params, x, mode, g, cache, pos)
            x = self._mamba_group(params["mamba"][g], x, cache["ssm"][g],
                                  cache["conv"][g])
        return rms_norm(x, params["ln_f"], self.cfg.norm_eps)

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) -> (logits (B, T, V), aux loss 0): every Mamba2
        layer from a zero state, no KV cache kept."""
        x = params["embed"][tokens.long()]
        ssm_shape, conv_shape = mamba2_state_shapes(self.cfg, x.shape[0])
        for g in range(self.n_groups):
            x = self._shared_attn(params, x, "full")
            group = params["mamba"][g]
            x = self._mamba_group(
                group, x,
                [x.new_zeros(ssm_shape, dtype=torch.float32) for _ in group],
                [x.new_zeros(conv_shape) for _ in group])
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return x @ params["unembed"], torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL in fp32; forward only: the port has no
        training path yet."""
        logits, _ = self.forward(params, batch["tokens"])
        logp = F.log_softmax(logits.float(), dim=-1)
        labels = batch["labels"].long()
        return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()

    # ------------------------------------------------------------ serving
    def prefill(self, params: Params, tokens: torch.Tensor, cache):
        """Full-sequence pass from the cache's states that writes each
        application's KV positions [0, T) and every layer's final state,
        in place.  Returns (last-position logits (B, V), cache)."""
        x = self._run(params, params["embed"][tokens.long()], cache,
                      "prefill")
        return x[:, -1, :] @ params["unembed"], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: Union[int, torch.Tensor]):
        """tokens (B, 1) at the shared position `pos` (an int or a 0-d
        tensor).  Writes the cache in place; returns (logits (B, V),
        cache)."""
        x = self._run(params, params["embed"][tokens.long()], cache,
                      "decode", pos)
        return x[:, 0, :] @ params["unembed"], cache
