"""Weight carry-over: the reference's parameter pytree as the port's params.

The JAX package's `TransformerModel.init` returns a pytree whose `pattern`
entries stack each pattern position's blocks over a leading `n_repeats`
axis (for its layer scan), and its `ZambaModel.init` one whose `mamba`
entry stacks every Mamba2 layer over (n_groups, attn_every), and its
`RWKVModel.init` one whose `blocks` entry stacks every layer over a
leading L axis.  The port keeps one block dict per layer
(`models/transformer.py`, `models/zamba.py`, `models/rwkv.py`).
`params_from_numpy` takes any of these reference trees with numpy
leaves (`jax.tree.map(np.asarray, params)`) and returns the port's
layout on a torch device, so both packages compute with the same
numbers.  JAX and PyTorch draw different numbers from the same seed, so
parity goes through this function, never through equal seeds.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

Params = Dict[str, Any]


def _tensor(a: np.ndarray, device: Union[str, torch.device, None]
                      = None, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, which numpy holds through
    ml_dtypes and torch cannot wrap) as a tensor on `device`, in `dtype`
    if given; bf16 goes through an exact fp32 copy."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


#: Mamba2 leaves the reference draws in fp32 whatever the model dtype
_FP32_LEAVES = ("A_log", "D", "dt_bias")
#: RWKV6 time-mix leaves the reference draws in fp32 whatever the dtype
_RWKV_FP32_LEAVES = ("w0", "u")
#: the MoE router, which the reference draws in fp32 whatever the dtype
_MOE_FP32_LEAVES = ("router",)


def _tree(a, device, dtype, name: str = "", fp32=_FP32_LEAVES):
    if isinstance(a, dict):
        return {k: _tree(v, device, dtype, k, fp32) for k, v in a.items()}
    return _tensor(a, device, None if name in fp32 else dtype)


def _unstack(tree, r: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return tree[r]


def params_from_numpy(ref: Params, device: Union[str, torch.device, None]
                      = None, dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's params (numpy leaves) in the port's layout:
    `embed`, `unembed`, `ln_f` as they are; for a transformer, `prologue`
    one block per layer and each stacked `pattern` entry split along its
    leading repeat axis into a list of per-layer blocks (nested dicts,
    such as an MoE layer's `shared` MLP, carried across); for Zamba
    (a `mamba` key), `shared_attn` as it is and `mamba` split into
    `[group][layer]` dicts; for RWKV6 (a `blocks` key), `blocks` split
    along its leading layer axis into a list.  `dtype` casts every tensor
    but the Mamba2, RWKV6 and MoE-router fp32 leaves (default: the
    reference's own dtype)."""
    out = {k: _tensor(ref[k], device, dtype)
           for k in ("embed", "unembed", "ln_f")}
    if "blocks" in ref:
        whole = _tree(ref["blocks"], device, dtype, fp32=_RWKV_FP32_LEAVES)
        n_layers = _first_leaf(whole).shape[0]
        out["blocks"] = [_unstack(whole, i) for i in range(n_layers)]
        return out
    if "mamba" in ref:
        out["shared_attn"] = _tree(ref["shared_attn"], device, dtype)
        whole = _tree(ref["mamba"], device, dtype)
        n_groups, per_group = _first_leaf(whole).shape[:2]
        out["mamba"] = [[_unstack(_unstack(whole, g), k)
                         for k in range(per_group)]
                        for g in range(n_groups)]
        return out
    out["prologue"] = [_tree(p, device, dtype, fp32=_MOE_FP32_LEAVES)
                       for p in ref["prologue"]]
    out["pattern"] = []
    for stacked in ref["pattern"]:
        whole = _tree(stacked, device, dtype, fp32=_MOE_FP32_LEAVES)
        n_repeats = _first_leaf(whole).shape[0]
        out["pattern"].append([_unstack(whole, r) for r in range(n_repeats)])
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree
