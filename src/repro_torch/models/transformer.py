"""Generic decoder-only transformer stack (the port's dense GQA models).

The port's counterpart of `repro.models.transformer`.  Layer heterogeneity
is a repeating *pattern* of block kinds, as in the reference
(`layer_program`):

  codeqwen1.5-7b, qwen2.5-32b, llama3-405b, chameleon-34b:
                 prologue=[]         pattern=[gqa+mlp] x n_layers
  deepseek-v2-lite-16b:
                 prologue=[mla+mlp]  pattern=[mla+moe] x26
  llama4-scout:  prologue=[]         pattern=[gqa+moe] x48
  gemma3-12b:    prologue=[]         pattern=[5 x local(gqa+mlp, window),
                                              1 x global(gqa+mlp)] x8

The reference stacks each pattern position's parameters over the repeat
axis and scans; PyTorch runs eagerly, so the port keeps one parameter dict
and one cache pair per layer and loops over them in the reference's order
(repeat, then pattern position).  `models/weights.py` turns the
reference's stacked pytree into this layout.  A GQA layer caches (k, v)
pairs of (B, S, kv, hd); an MLA layer (`models/mla.py`) its latent and
rope key, (B, S, kv_lora_rank) and (B, S, qk_rope_head_dim).  An MoE
layer (`models/moe.py`) returns its aux loss.  MLA stacks mask no pads
and take only a shared decode position (`pad_aware`), as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.coexec import resolve_device
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnSpec, attention_decode,
                                       attention_full, attention_prefill,
                                       init_attention, init_mlp, mlp,
                                       rms_norm)

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class BlockKind:
    attn: str                    # 'gqa' | 'mla'
    ffn: str                     # 'mlp' | 'moe'
    window: int = 0              # sliding window (0 = full)


def layer_program(cfg: ModelConfig) -> Tuple[List[BlockKind],
                                             List[BlockKind], int]:
    """Returns (prologue_blocks, pattern_blocks, n_repeats)."""
    window = cfg.sliding_window
    attn = cfg.attn_kind
    if cfg.is_moe:
        if cfg.first_dense_layers:
            pro = [BlockKind(attn, "mlp")] * cfg.first_dense_layers
            n = cfg.n_layers - cfg.first_dense_layers
            return pro, [BlockKind(attn, "moe")], n
        if cfg.moe_interleave > 1:
            pat = [BlockKind(attn, "mlp")] * (cfg.moe_interleave - 1) \
                + [BlockKind(attn, "moe")]
            assert cfg.n_layers % cfg.moe_interleave == 0
            return [], pat, cfg.n_layers // cfg.moe_interleave
        return [], [BlockKind(attn, "moe")], cfg.n_layers
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        pat = [BlockKind(attn, "mlp", window=window)] * r \
            + [BlockKind(attn, "mlp", window=0)]
        assert cfg.n_layers % (r + 1) == 0
        return [], pat, cfg.n_layers // (r + 1)
    return [], [BlockKind(attn, "mlp", window=window)], cfg.n_layers


def _attn_spec(cfg: ModelConfig, window: int) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
                    qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                    sliding_window=window)


# ------------------------------------------------------------------ blocks
def init_block(generator: torch.Generator, cfg: ModelConfig, kind: BlockKind,
               dtype: torch.dtype) -> Params:
    dev = generator.device
    p: Params = {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
                 "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    if kind.attn == "mla":
        p["attn"] = mla_mod.init_mla(generator, cfg, dtype)
    else:
        p["attn"] = init_attention(generator, cfg.d_model,
                                   _attn_spec(cfg, kind.window), dtype)
    if kind.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(generator, cfg, dtype)
    else:
        p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig,
         kind: BlockKind) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's feed-forward half on the normed `h`: (out, aux loss)."""
    if kind.ffn == "moe":
        return moe_mod.moe_layer(p["ffn"], h, cfg)
    return mlp(p["ffn"], h), torch.zeros((), dtype=torch.float32,
                                         device=h.device)


def block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  kind: BlockKind) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind.attn == "mla":
        h = mla_mod.mla_full(p["attn"], h, cfg)
    else:
        h = attention_full(p["attn"], h, _attn_spec(cfg, kind.window))
    x = x + h
    h, aux = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg, kind)
    return x + h, aux


def block_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  kind: BlockKind, start: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Tuple[torch.Tensor, torch.Tensor]]:
    """Like block_forward but also returns the pair to cache: (k, v) for
    GQA, (c_kv, k_rope) for MLA."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind.attn == "mla":
        h, kv = mla_mod.mla_prefill(p["attn"], h, cfg)
    else:
        h, kv = attention_prefill(p["attn"], h, _attn_spec(cfg, kind.window),
                                  start=start)
    x = x + h
    h, aux = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg, kind)
    return x + h, aux, kv


def block_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 kind: BlockKind, cache: Tuple[torch.Tensor, torch.Tensor],
                 pos: Union[int, torch.Tensor],
                 start: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind.attn == "mla":
        h, ck, cv = mla_mod.mla_decode(p["attn"], h, cfg, cache[0], cache[1],
                                       pos)
    else:
        h, ck, cv = attention_decode(p["attn"], h,
                                     _attn_spec(cfg, kind.window), cache[0],
                                     cache[1], pos, start=start)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind.ffn == "moe":
        h, _ = moe_mod.moe_layer(p["ffn"], h, cfg)
    else:
        h = mlp(p["ffn"], h)      # no aux: a decode step makes no zeros
    return x + h, (ck, cv)


# ------------------------------------------------------------------- model
class TransformerModel:
    """Decoder-only LM with the reference's uniform model API.

    `params["prologue"]` holds one block dict per prologue layer and
    `params["pattern"][j][r]` the block of pattern position j in repeat r;
    caches mirror that layout with one pair per layer (`cache_spec`).  Every tensor lives on the device the caller chose
    (`init(generator)` draws on the generator's device; `init_cache(...,
    device=)`)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.prologue, self.pattern, self.n_repeats = layer_program(cfg)
        self.dtype = DTYPES[cfg.dtype]

    def _layers(self, params: Params, cache=None
                ) -> Iterator[Tuple[Params, BlockKind, Any]]:
        """(block params, kind, cache pair or None) in execution order."""
        for i, kind in enumerate(self.prologue):
            yield (params["prologue"][i], kind,
                   None if cache is None else cache["prologue"][i])
        for r in range(self.n_repeats):
            for j, kind in enumerate(self.pattern):
                yield (params["pattern"][j][r], kind,
                       None if cache is None else cache["pattern"][j][r])

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Params:
        """Seeded weights with the reference's shapes and scales, drawn
        from `generator` on its device (a CUDA generator draws on the card:
        nothing is made on the host and copied)."""
        cfg, dt, dev = self.cfg, self.dtype, generator.device
        params: Params = {
            "embed": torch.randn((cfg.vocab_size, cfg.d_model),
                                 generator=generator, device=dev,
                                 dtype=dt).mul_(0.02),
            "unembed": torch.randn((cfg.d_model, cfg.vocab_size),
                                   generator=generator, device=dev,
                                   dtype=dt).mul_(cfg.d_model ** -0.5),
            "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        }
        params["prologue"] = [init_block(generator, cfg, kind, dt)
                              for kind in self.prologue]
        params["pattern"] = [[init_block(generator, cfg, kind, dt)
                              for _ in range(self.n_repeats)]
                             for kind in self.pattern]
        return params

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) -> (logits (B,T,V), aux_loss)."""
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, kind, _ in self._layers(params):
            x, aux = block_forward(p, x, cfg, kind)
            aux_total = aux_total + aux
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x @ params["unembed"], aux_total

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL (+ 0.01 x aux) in fp32; forward only: the
        port has no training path yet."""
        logits, aux = self.forward(params, batch["tokens"])
        logp = F.log_softmax(logits.float(), dim=-1)
        labels = batch["labels"].long()
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        return nll.mean() + 0.01 * aux

    # ------------------------------------------------------------ serving
    def cache_spec(self, batch: int, max_len: int,
                   device: Union[str, torch.device, None] = None):
        """The cache: one zeroed pair per layer, in the params' layout, on
        `device` (CUDA unless given; raises where CUDA is missing): (k, v)
        of (batch, max_len, kv, hd) each, or for an MLA stack (c_kv,
        k_rope) of (batch, max_len, kv_lora_rank) and (batch, max_len,
        qk_rope_head_dim)."""
        cfg = self.cfg
        device = resolve_device(device)
        if cfg.attn_kind == "mla":
            k_shape = (batch, max_len, cfg.kv_lora_rank)
            v_shape = (batch, max_len, cfg.qk_rope_head_dim)
        else:
            k_shape = v_shape = (batch, max_len, cfg.n_kv_heads,
                                 cfg.head_dim)

        def pair():
            return (torch.zeros(k_shape, dtype=self.dtype, device=device),
                    torch.zeros(v_shape, dtype=self.dtype, device=device))
        return {"prologue": [pair() for _ in self.prologue],
                "pattern": [[pair() for _ in range(self.n_repeats)]
                            for _ in self.pattern]}

    def init_cache(self, batch: int, max_len: int,
                   device: Union[str, torch.device, None] = None):
        return self.cache_spec(batch, max_len, device)

    @property
    def pad_aware(self) -> bool:
        """True when prefill/decode accept a per-row `start` pad boundary
        (the GQA attention path; MLA caches latents and cannot mask pads
        without re-deriving per-row keys)."""
        return all(k.attn != "mla" for k in self.prologue + self.pattern)

    # decode_step accepts a (B,) pos vector (one timeline per batch slot)
    # on the same attention paths that support pad masking
    per_slot_pos = pad_aware

    def _check_padded(self, start) -> None:
        if start is not None and not self.pad_aware:
            raise ValueError("per-row start masking requires pad_aware "
                             "attention (gqa); this stack contains mla")

    def prefill(self, params: Params, tokens: torch.Tensor, cache,
                start: Optional[torch.Tensor] = None):
        """Full-sequence causal pass that also fills the KV cache's first T
        positions (in place).  Returns (last-position logits, cache).
        `start` (B,) marks each row's first real token in a left-padded
        batch; positions before it are masked out of every softmax."""
        cfg = self.cfg
        self._check_padded(start)
        x = params["embed"][tokens.long()]
        t = x.shape[1]
        for p, kind, (ck, cv) in self._layers(params, cache):
            x, _, (k, v) = block_prefill(p, x, cfg, kind, start=start)
            ck[:, :t] = k.to(ck.dtype)
            cv[:, :t] = v.to(cv.dtype)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x[:, -1, :] @ params["unembed"], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: Union[int, torch.Tensor],
                    start: Optional[torch.Tensor] = None):
        """tokens (B,1); pos: the position being written — an int (or a
        0-d tensor) shared by every row, or a (B,) tensor when each batch
        slot runs its own timeline (continuous batching).  `start` (B,)
        masks cache entries before each row's first real token.  Writes
        the cache in place; returns (logits (B, V), cache)."""
        cfg = self.cfg
        self._check_padded(start)
        if torch.is_tensor(pos) and pos.dim() == 1 and not self.per_slot_pos:
            raise ValueError("per-slot pos vector requires gqa attention; "
                             "this stack contains mla")
        x = params["embed"][tokens.long()]
        for p, kind, c in self._layers(params, cache):
            x, _ = block_decode(p, x, cfg, kind, c, pos, start=start)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return (x @ params["unembed"])[:, 0, :], cache
