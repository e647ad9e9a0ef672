"""Whisper-style encoder-decoder transformer (arXiv:2212.04356).

The port's counterpart of `repro.models.encdec`, op for op.  As in the
reference, the mel-spectrogram and conv feature extractor frontend is a
stub: the model takes precomputed frame embeddings of shape (B,
encoder_seq, d_model).  Positions are sinusoidal in both stacks (the
published model learns its decoder's), and Q/K/V are projected at
position 0 everywhere, where RoPE is the identity.

The reference stacks each stack's layers for a scan; PyTorch runs
eagerly, so the port keeps one param dict per layer
(`params["encoder"][l]`, `params["decoder"][l]`) and one self-attention
cache pair per decoder layer (`cache["self_k"][l]`, `cache["self_v"][l]`,
each (B, S, kv, hd)), plus the encoder's output `cache["enc"]`;
`models/weights.py` turns the reference's stacked pytree into this
layout.  Prefill and decode write the cache in place.  Each decoder
layer's cross K/V are recomputed from `cache["enc"]` on every pass, as
the reference recomputes them.  No layer reaches a hand-written kernel:
the reference's Whisper runs no Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.coexec import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (DECODE_FLASH_THRESHOLD,
                                       FLASH_THRESHOLD, AttnSpec,
                                       _causal_mask, _project_qkv,
                                       attention_scores, init_attention,
                                       init_mlp, mlp, rms_norm)
from repro_torch.models.transformer import DTYPES

Params = Dict[str, Any]


def sinusoidal_positions(t0: int, t1: int, d: int,
                         device: Union[str, torch.device, None] = None
                         ) -> torch.Tensor:
    """(t1 - t0, d) fp32: sines of every position's d/2 angles, then
    cosines."""
    pos = torch.arange(t0, t1, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _sin_pos_dynamic(pos: Union[int, torch.Tensor], d: int,
                     device: Union[str, torch.device, None] = None
                     ) -> torch.Tensor:
    """Sinusoidal embedding of one position (an int or a 0-d tensor, kept
    on its device): (1, 1, d) fp32."""
    posf = torch.as_tensor(pos, dtype=torch.float32, device=device)
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=posf.device)
    angle = posf / torch.pow(10000.0, dim / d)                 # (d/2,)
    return torch.cat([torch.sin(angle), torch.cos(angle)])[None, None, :]


def init_cross_attention(generator: torch.Generator, d_model: int,
                         spec: AttnSpec,
                         dtype: torch.dtype = torch.bfloat16) -> Params:
    return init_attention(generator, d_model, spec, dtype)


def cross_attention(p: Params, x: torch.Tensor, kv_k: torch.Tensor,
                    kv_v: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """x: (B,T,D) queries; kv_k/kv_v: (B,S,kv,hd) precomputed from enc."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, spec.n_heads, spec.head_dim)
    mask = torch.ones((t, kv_k.shape[1]), dtype=torch.bool, device=x.device)
    out = attention_scores(q, kv_k, kv_v, mask)
    return out.reshape(b, t, -1) @ p["wo"]


def cross_kv(p: Params, enc: torch.Tensor, spec: AttnSpec
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = enc.shape
    kv, hd = spec.n_kv_heads, spec.head_dim
    k = (enc @ p["wk"]).reshape(b, s, kv, hd)
    v = (enc @ p["wv"]).reshape(b, s, kv, hd)
    return k, v


def cross_kv_all(cross_params: List[Params], enc: torch.Tensor,
                 spec: AttnSpec) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every decoder layer's cross K/V, one (B,S,kv,hd) pair per layer
    (the reference stacks them over a leading layer axis)."""
    return [cross_kv(p, enc, spec) for p in cross_params]


class EncDecModel:
    """The reference's model API (`init`, `encode`, `loss`, `init_cache`,
    `prefill`, `decode_step`) on the device the caller chose."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.spec = AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Params:
        """Seeded weights with the reference's shapes and scales, drawn
        from `generator` on its device."""
        cfg, dt, dev, spec = self.cfg, self.dtype, generator.device, self.spec
        d = cfg.d_model

        def ones():
            return torch.ones((d,), dtype=dt, device=dev)

        encoder = [{"ln1": ones(), "ln2": ones(),
                    "attn": init_attention(generator, d, spec, dt),
                    "mlp": init_mlp(generator, d, cfg.d_ff, dt)}
                   for _ in range(cfg.encoder_layers)]
        decoder = [{"ln1": ones(), "ln2": ones(), "ln3": ones(),
                    "self_attn": init_attention(generator, d, spec, dt),
                    "cross_attn": init_cross_attention(generator, d, spec,
                                                       dt),
                    "mlp": init_mlp(generator, d, cfg.d_ff, dt)}
                   for _ in range(cfg.n_layers)]
        return {
            "embed": torch.randn((cfg.vocab_size, d), generator=generator,
                                 device=dev, dtype=dt).mul_(0.02),
            "unembed": torch.randn((d, cfg.vocab_size), generator=generator,
                                   device=dev, dtype=dt).mul_(
                                       1.0 / math.sqrt(d)),
            "ln_enc": ones(),
            "ln_dec": ones(),
            "encoder": encoder,
            "decoder": decoder,
        }

    # ------------------------------------------------------------- encode
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, D) stubbed conv-frontend embeddings."""
        cfg, spec = self.cfg, self.spec
        b, s, d = frames.shape
        dev = frames.device
        x = frames.to(self.dtype) \
            + sinusoidal_positions(0, s, d, dev).to(self.dtype)
        full = torch.ones((s, s), dtype=torch.bool, device=dev)
        positions = torch.zeros((b, s), dtype=torch.int32, device=dev)
        for p in params["encoder"]:
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = _project_qkv(p["attn"], h, spec, positions)
            h = attention_scores(q, k, v, full).reshape(b, s, -1) \
                @ p["attn"]["wo"]
            x = x + h
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp(p["mlp"], h)
        return rms_norm(x, params["ln_enc"], cfg.norm_eps)

    # ------------------------------------------------------------ decoder
    def _dec_embed(self, params: Params, tokens: torch.Tensor,
                   pos0: int = 0) -> torch.Tensor:
        assert pos0 == 0
        x = params["embed"][tokens.long()]
        pe = sinusoidal_positions(0, tokens.shape[1], self.cfg.d_model,
                                  x.device)
        return x + pe.to(x.dtype)

    def _self_attention(self, p: Params, h: torch.Tensor, mode: str,
                        cache_k=None, cache_v=None, pos=None
                        ) -> torch.Tensor:
        """The decoder's self-attention in `mode`: "train" causal over the
        sequence, "prefill" the same while writing positions [0, T) of the
        layer's cache, "decode" one token written at `pos` (a 0-d tensor)
        attending to the cache up to it."""
        b, t, _ = h.shape
        positions = torch.zeros((b, t), dtype=torch.int32, device=h.device)
        q, k, v = _project_qkv(p, h, self.spec, positions)
        if mode == "decode":
            # the reference's dynamic_update_slice clamps its start
            at = pos.long().clamp(0, cache_k.shape[1] - 1).reshape(1)
            cache_k.index_copy_(1, at, k.to(cache_k.dtype))
            cache_v.index_copy_(1, at, v.to(cache_v.dtype))
            sk, sv = cache_k.to(q.dtype), cache_v.to(q.dtype)
            if cache_k.shape[1] >= DECODE_FLASH_THRESHOLD:
                from repro_torch.models.flash import flash_decode
                out = flash_decode(q, sk, sv, pos)
            else:
                mask = (torch.arange(cache_k.shape[1], device=h.device)
                        <= pos)[None, :]
                out = attention_scores(q, sk, sv, mask)
        else:
            if mode == "prefill":
                cache_k[:, :t] = k.to(cache_k.dtype)
                cache_v[:, :t] = v.to(cache_v.dtype)
            if t >= FLASH_THRESHOLD:
                from repro_torch.models.flash import flash_full
                out = flash_full(q, k, v)
            else:
                out = attention_scores(q, k, v,
                                       _causal_mask(t, t, device=h.device))
        return out.reshape(b, t, -1) @ p["wo"]

    def _decoder_stack(self, params: Params, x: torch.Tensor,
                       enc: torch.Tensor, mode: str, cache=None, pos=None):
        """Every decoder layer in `mode` ("train", "prefill", "decode");
        each layer's cross K/V from `enc`.  Returns (x, cache): None in
        "train", else the cache with its self-attention pairs written in
        place."""
        cfg, spec = self.cfg, self.spec
        for i, p in enumerate(params["decoder"]):
            ck, cv = cross_kv(p["cross_attn"], enc, spec)
            sk, sv = ((None, None) if cache is None else
                      (cache["self_k"][i], cache["self_v"][i]))
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + self._self_attention(p["self_attn"], h, mode, sk, sv,
                                         pos)
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + cross_attention(p["cross_attn"], h, ck, cv, spec)
            h = rms_norm(x, p["ln3"], cfg.norm_eps)
            x = x + mlp(p["mlp"], h)
        return x, cache

    # ---------------------------------------------------------------- api
    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL in fp32 of the decoder teacher-forced on
        `batch["tokens"]` over `batch["frames"]`."""
        enc = self.encode(params, batch["frames"])
        x = self._dec_embed(params, batch["tokens"], 0)
        x, _ = self._decoder_stack(params, x, enc, "train")
        x = rms_norm(x, params["ln_dec"], self.cfg.norm_eps)
        logits = (x @ params["unembed"]).float()
        logp = F.log_softmax(logits, dim=-1)
        labels = batch["labels"].long()
        return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()

    def init_cache(self, batch: int, max_len: int,
                   device: Union[str, torch.device, None] = None):
        """Zeroed caches on `device` (CUDA unless given): per decoder layer
        a (k, v) pair of (batch, max_len, kv, hd), and the encoder output
        (batch, encoder_seq, d_model), in the model dtype."""
        cfg = self.cfg
        device = resolve_device(device)
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)

        def per_layer():
            return [torch.zeros(shape, dtype=self.dtype, device=device)
                    for _ in range(cfg.n_layers)]

        return {"self_k": per_layer(), "self_v": per_layer(),
                "enc": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                   dtype=self.dtype, device=device)}

    def prefill(self, params: Params, tokens: torch.Tensor, cache,
                frames: torch.Tensor):
        """Encode `frames`, then the decoder over `tokens` from position 0,
        writing the self-attention caches' first T positions and the
        encoder output in place.  Returns (last-position logits (B, V),
        cache)."""
        enc = self.encode(params, frames)
        cache["enc"].copy_(enc)
        x = self._dec_embed(params, tokens, 0)
        x, cache = self._decoder_stack(params, x, enc, "prefill",
                                       cache=cache)
        x = rms_norm(x, params["ln_dec"], self.cfg.norm_eps)
        return x[:, -1, :] @ params["unembed"], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: Union[int, torch.Tensor]):
        """tokens (B, 1) at the shared position `pos` (an int or a 0-d
        tensor, which stays on its device: no host sync).  Writes the
        cache in place; returns (logits (B, V), cache)."""
        pos = torch.as_tensor(pos, device=tokens.device)
        x = params["embed"][tokens.long()] \
            + _sin_pos_dynamic(pos, self.cfg.d_model).to(self.dtype)
        x, cache = self._decoder_stack(params, x, cache["enc"], "decode",
                                       cache=cache, pos=pos)
        x = rms_norm(x, params["ln_dec"], self.cfg.norm_eps)
        return x[:, 0, :] @ params["unembed"], cache
