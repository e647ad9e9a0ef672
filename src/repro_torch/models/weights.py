"""Weight carry-over: the reference's parameter pytree as the port's params.

The JAX package's `TransformerModel.init` returns a pytree whose `pattern`
entries stack each pattern position's blocks over a leading `n_repeats`
axis (for its layer scan), and its `ZambaModel.init` one whose `mamba`
entry stacks every Mamba2 layer over (n_groups, attn_every), and its
`RWKVModel.init` one whose `blocks` entry stacks every layer over a
leading L axis, and its `EncDecModel.init` one whose `encoder` and
`decoder` entries stack each stack's layers over a leading L axis.  The
port keeps one block dict per layer (`models/transformer.py`,
`models/zamba.py`, `models/rwkv.py`, `models/encdec.py`).
`params_from_numpy` takes any of these reference trees with numpy
leaves (`jax.tree.map(np.asarray, params)`) or torch leaves and returns
the port's layout on a torch device, so both packages compute with the
same numbers.  JAX and PyTorch draw different numbers from the same
seed, so parity goes through this function, never through equal seeds.
Its inverses, `params_to_reference` (torch leaves on the CPU) and
`params_to_numpy`, give the reference's layout back, leaf for leaf and
dtype for dtype: a checkpoint (`repro_torch.checkpoint`) stores that
layout, so either package loads the other's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def _tensor(a, device: Union[str, torch.device, None] = None,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, which numpy holds through
    ml_dtypes and torch cannot wrap) or a tensor as a tensor on `device`,
    in `dtype` if given; bf16 goes through an exact fp32 copy."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype or a.dtype)
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
    return tree_map(lambda t: t[r], tree)


def params_from_numpy(ref: Params, device: Union[str, torch.device, None]
                      = None, dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's params (numpy leaves) in the port's layout:
    `embed`, `unembed`, `ln_f` as they are; for a transformer, `prologue`
    one block per layer and each stacked `pattern` entry split along its
    leading repeat axis into a list of per-layer blocks (nested dicts,
    such as an MoE layer's `shared` MLP, carried across); for Zamba
    (a `mamba` key), `shared_attn` as it is and `mamba` split into
    `[group][layer]` dicts; for RWKV6 (a `blocks` key), `blocks` split
    along its leading layer axis into a list; for Whisper (an `encoder`
    key), `ln_enc` and `ln_dec` as they are and `encoder` and `decoder`
    each split along its leading layer axis into a list.  `dtype` casts
    every tensor but the Mamba2, RWKV6 and MoE-router fp32 leaves
    (default: the reference's own dtype)."""
    if "encoder" in ref:
        out = {k: _tensor(ref[k], device, dtype)
               for k in ("embed", "unembed", "ln_enc", "ln_dec")}
        for stack in ("encoder", "decoder"):
            whole = _tree(ref[stack], device, dtype)
            out[stack] = [_unstack(whole, i)
                          for i in range(next(tree_leaves(whole)).shape[0])]
        return out
    out = {k: _tensor(ref[k], device, dtype)
           for k in ("embed", "unembed", "ln_f")}
    if "blocks" in ref:
        whole = _tree(ref["blocks"], device, dtype, fp32=_RWKV_FP32_LEAVES)
        n_layers = next(tree_leaves(whole)).shape[0]
        out["blocks"] = [_unstack(whole, i) for i in range(n_layers)]
        return out
    if "mamba" in ref:
        out["shared_attn"] = _tree(ref["shared_attn"], device, dtype)
        whole = _tree(ref["mamba"], device, dtype)
        n_groups, per_group = next(tree_leaves(whole)).shape[:2]
        out["mamba"] = [[_unstack(_unstack(whole, g), k)
                         for k in range(per_group)]
                        for g in range(n_groups)]
        return out
    out["prologue"] = [_tree(p, device, dtype, fp32=_MOE_FP32_LEAVES)
                       for p in ref["prologue"]]
    out["pattern"] = []
    for stacked in ref["pattern"]:
        whole = _tree(stacked, device, dtype, fp32=_MOE_FP32_LEAVES)
        n_repeats = next(tree_leaves(whole)).shape[0]
        out["pattern"].append([_unstack(whole, r) for r in range(n_repeats)])
    return out


def _stack(trees):
    """Per-layer trees (dicts of tensors) stacked leaf by leaf over a new
    leading axis, on the CPU."""
    return tree_map(lambda *ts: torch.stack([t.detach().cpu() for t in ts]),
                    *trees)


def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu(), tree)


def params_to_reference(params: Params) -> Params:
    """The port's params in the reference's layout, torch leaves on the
    CPU in each leaf's own dtype: the inverse of `params_from_numpy`.
    Each per-layer list is stacked over a leading axis (a Zamba2 model's
    `mamba` over (n_groups, attn_every)); a transformer's `prologue`
    stays a list of block dicts, as the reference keeps it."""
    if "encoder" in params:
        out = {k: _cpu(params[k])
               for k in ("embed", "unembed", "ln_enc", "ln_dec")}
        out["encoder"] = _stack(params["encoder"])
        out["decoder"] = _stack(params["decoder"])
        return out
    out = {k: _cpu(params[k]) for k in ("embed", "unembed", "ln_f")}
    if "blocks" in params:
        out["blocks"] = _stack(params["blocks"])
    elif "mamba" in params:
        out["shared_attn"] = _cpu(params["shared_attn"])
        groups = [_stack(group) for group in params["mamba"]]
        out["mamba"] = _stack(groups)
    else:
        out["prologue"] = [_cpu(p) for p in params["prologue"]]
        out["pattern"] = [_stack(repeats) for repeats in params["pattern"]]
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array of its dtype; bf16 through its bits
    (a uint16 view) as an `ml_dtypes.bfloat16` array, which is what the
    reference's `np.asarray` of a bf16 leaf gives."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Params) -> Params:
    """`params_to_reference` with numpy leaves: the tree
    `jax.tree.map(np.asarray, reference_params)` gives, so
    `params_to_numpy(params_from_numpy(ref))` equals `ref` leaf for leaf.
    bf16 leaves need `ml_dtypes` (a checkpoint does not: it stores bf16
    through torch's integer views)."""
    return tree_map(_numpy, params_to_reference(params))
