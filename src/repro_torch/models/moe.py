"""Mixture-of-Experts layer with capacity-based scatter dispatch (plain
PyTorch).

The port's counterpart of `repro.models.moe`, op for op.  Each token is
routed to its top-k experts by an fp32 softmax router; each expert takes
at most `capacity = max(1, int(capacity_factor * N * k / E))` of the N
tokens of the call, queued in flat (token, slot) order, and the (token,
slot) pairs past capacity are dropped (their gate counts for nothing).  A
token's output therefore depends on the other tokens of the same call,
exactly as in the reference.

Dispatch writes the kept tokens into an (E * C + 1, D) buffer (dropped
pairs go to a sink row that is cut away) with `index_add_`, runs the three
expert products as batched matmuls over (E, C, D), and gathers each
(token, slot) back for the gate-weighted combine; the shared experts are
one dense MLP.  Kept slots are unique, so the scatter is deterministic.

The port has one device, so it ports the reference's unsharded branch:
with no mesh, `cfg.moe_local_dispatch` falls through to it there too, and
the reference's sharding constraints on the expert buffers are
identities.  Aux loss: the Switch load-balance loss plus 1e-3 x the
router z-loss, returned to the caller.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal, init_mlp, mlp

Params = Dict[str, torch.Tensor]


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.bfloat16) -> Params:
    """The reference's shapes and scales; the router is fp32 whatever
    `dtype` is."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p: Params = {
        "router": _normal(generator, (d, e), torch.float32, s_in),
        "w_gate": _normal(generator, (e, d, ff), dtype, s_in),
        "w_up": _normal(generator, (e, d, ff), dtype, s_in),
        "w_down": _normal(generator, (e, ff, d), dtype, s_out),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d,
                               cfg.moe_d_ff * cfg.n_shared_experts, dtype)
    return p


def expert_capacity(n_tokens: int, cfg: ModelConfig,
                    capacity_factor: float = 1.25) -> int:
    """Each expert's queue length for a call of `n_tokens` tokens."""
    return max(1, int(capacity_factor * n_tokens * cfg.experts_per_token
                      / cfg.n_experts))


def moe_layer(p: Params, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (y (B, T, D), aux loss)."""
    b, t, d = x.shape
    y, aux = _moe_core(p, x.reshape(b * t, d), cfg,
                       expert_capacity(b * t, cfg, capacity_factor))
    return y.reshape(b, t, d), aux


def route(p: Params, xt: torch.Tensor, cfg: ModelConfig, capacity: int):
    """The router over flat tokens xt (N, D): (fp32 logits (N, E), probs,
    renormalised gates (N, k), expert indices (N, k), queue positions
    (N, k), keep (N, k)).  Top-k is a stable descending sort, so a tie
    goes to the lower expert index, as `jax.lax.top_k` gives it."""
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ p["router"]                         # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # each (token, slot)'s place in its expert's queue: the exclusive
    # cumsum of the flat (N*k, E) one-hot down the pairs, taken along the
    # rows of its (E, N*k) transpose (a scan over a tensor's outer dim is
    # a slow kernel on CUDA); integers, so exact at any N
    flat = expert_idx.reshape(-1)
    queued = torch.cumsum(F.one_hot(flat, e).t().contiguous(), dim=1)
    pos = (queued.gather(0, flat[None, :])[0] - 1).reshape(expert_idx.shape)
    return logits, probs, gate_vals, expert_idx, pos, pos < capacity


def _moe_core(p: Params, xt: torch.Tensor, cfg: ModelConfig,
              capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter dispatch -> expert FFNs -> gather combine, over flat tokens."""
    n, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    logits, probs, gate_vals, expert_idx, pos, keep = route(p, xt, cfg,
                                                            capacity)
    # the kept pairs into the (E*C, D) buffer; dropped ones to the sink row
    slot = torch.where(keep, expert_idx * capacity + pos, e * capacity)
    buf = torch.zeros((e * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf.index_add_(0, slot.reshape(-1),
                   xt.repeat_interleave(k, dim=0) if k > 1 else xt)
    xin = buf[:-1].reshape(e, capacity, d)

    h = F.silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    yout = torch.bmm(h, p["w_down"])

    # gather back and combine with the renormalised gates
    gathered = yout.reshape(e * capacity, d)[
        torch.clamp(slot, max=e * capacity - 1)]              # (N, k, D)
    w_comb = (gate_vals * keep).to(gathered.dtype)
    y = torch.einsum("nkd,nk->nd", gathered, w_comb).to(xt.dtype)
    if "shared" in p:
        y = y + mlp(p["shared"], xt)

    # Switch load-balance loss + z-loss
    me = probs.mean(0)                                        # (E,)
    ce = F.one_hot(expert_idx, e).float().sum(1).mean(0)      # routed share
    aux = e * torch.sum(me * ce) + 1e-3 * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    return y, aux
