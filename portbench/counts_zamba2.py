"""Operations and bytes of a Zamba2 prefill call, from the published
configuration's keys and the call's shape alone: the yardstick of
`prefill_mfu` and `ssd_chunk_roofline.prefill`.

A call prefills B prompts of T tokens.  Its operations
(`prefill_call`):

- 2 x the projection parameters each token passes through: every
  layer's in_proj and out_proj, and at each hybrid layer the shared
  block's q/k/v, o, gate_up and down projections, the layer's adapter
  (A then B) and its linear;
- causal attention at each hybrid layer, 2 H hd T (T + 1) per sequence:
  the score and value products over the T (T + 1) / 2 pairs a causal
  mask keeps;
- the SSD scan's recurrence, 4 P N per token and Mamba head (the state's
  decay and update, and its read-out);
- the depthwise conv, 2 K C per token and layer;
- the lm_head at each sequence's last position, 2 d V.

Its bytes are the weights read once in bf16.  Each `ssd_chunk_scan` call
(`ssd_call`: one group's heads of one layer) moves x, B, C and y once at
2 bytes an element, the bf16 activations they stand for, and dt, a and
the entering and final states once at 4.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

from portbench.counts import Work

#: bytes of a bf16 element, and of an fp32 one
BF16, FP32 = 2, 4


def widths(cfg: Mapping[str, Any]) -> Dict[str, int]:
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    conv = d_in + 2 * cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    return {"d": d, "d_in": d_in, "conv": conv,
            "in_proj": d_in + conv + cfg["n_mamba_heads"],
            "wide": 2 * d, "f": cfg["intermediate_size"],
            "r": cfg["adapter_rank"],
            "hybrid": len(hybrid_ids(cfg))}


def hybrid_ids(cfg: Mapping[str, Any]) -> List[int]:
    """The hybrid layers, from `layers_block_type` where given."""
    kinds = cfg.get("layers_block_type")
    if kinds is not None:
        return [i for i, k in enumerate(kinds) if k == "hybrid"]
    return list(cfg["hybrid_layer_ids"])


def projection_params(cfg: Mapping[str, Any]) -> int:
    """Parameters one token passes through in the projections."""
    w = widths(cfg)
    d, f, r, wide = w["d"], w["f"], w["r"], w["wide"]
    mixer = d * w["in_proj"] + w["d_in"] * d
    shared = (wide * 3 * wide + wide * d + d * 2 * f + f * d
              + d * r + r * 2 * f + d * d)
    return cfg["num_hidden_layers"] * mixer + w["hybrid"] * shared


def weight_params(cfg: Mapping[str, Any]) -> int:
    """Every parameter the model holds (the lm_head tied)."""
    w = widths(cfg)
    d, f, wide, heads = w["d"], w["f"], w["wide"], cfg["n_mamba_heads"]
    k = cfg["mamba_d_conv"]
    mixer = (d * w["in_proj"] + (k + 1) * w["conv"] + 3 * heads
             + w["d_in"] + w["d_in"] * d + d)
    block = wide + wide * 3 * wide + wide * d + d + d * 2 * f + f * d
    hybrid = d * d + d * w["r"] + w["r"] * 2 * f
    return (cfg["vocab_size"] * d + d + cfg["num_hidden_layers"] * mixer
            + cfg["num_mem_blocks"] * block + w["hybrid"] * hybrid)


def prefill_call(cfg: Mapping[str, Any], batch: int, t: int) -> Work:
    """One prefill of `batch` prompts of `t` tokens."""
    w = widths(cfg)
    tokens = batch * t
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    layers = cfg["num_hidden_layers"]
    flops = (2.0 * projection_params(cfg) * tokens
             + w["hybrid"] * batch * 2.0 * heads * hd * t * (t + 1)
             + layers * tokens * 4.0 * cfg["n_mamba_heads"]
             * cfg["mamba_headdim"] * cfg["mamba_d_state"]
             + layers * tokens * 2.0 * cfg["mamba_d_conv"] * w["conv"]
             + batch * 2.0 * w["d"] * cfg["vocab_size"])
    return Work(flops, float(BF16 * weight_params(cfg)))


def ssd_call(cfg: Mapping[str, Any], batch: int, t: int) -> Work:
    """One `ssd_chunk_scan` call: one group's H / G heads of one layer."""
    h = cfg["n_mamba_heads"] // cfg["mamba_ngroups"]
    p, n = cfg["mamba_headdim"], cfg["mamba_d_state"]
    tokens = batch * t
    flops = 4.0 * p * n * h * tokens
    moved = (BF16 * (2 * tokens * h * p + 2 * tokens * n)
             + FP32 * (tokens * h + h + 2 * batch * h * p * n))
    return Work(flops, float(moved))


def ssd_calls(cfg: Mapping[str, Any], batch: int, t: int) -> List[Work]:
    """Every scan call of one prefill: one per group and layer."""
    return [ssd_call(cfg, batch, t)] * (cfg["num_hidden_layers"]
                                        * cfg["mamba_ngroups"])
