"""Weight carry-over: the reference's parameter pytree as the port's params.

The JAX package's `TransformerModel.init` returns a pytree whose `pattern`
entries stack each pattern position's blocks over a leading `n_repeats`
axis (for its layer scan).  The port keeps one block dict per layer
(`models/transformer.py`).  `params_from_numpy` takes the reference's tree
with numpy leaves (`jax.tree.map(np.asarray, params)`) and returns the
port's layout on a torch device, so both packages compute with the same
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


def _tree(a, device, dtype):
    if isinstance(a, dict):
        return {k: _tree(v, device, dtype) for k, v in a.items()}
    return _tensor(a, device, dtype)


def _unstack(tree, r: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return tree[r]


def params_from_numpy(ref: Params, device: Union[str, torch.device, None]
                      = None, dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's transformer params (numpy leaves) in the port's
    layout: `embed`, `unembed`, `ln_f` as they are, `prologue` one block
    per layer, and each stacked `pattern` entry split along its leading
    repeat axis into a list of per-layer blocks.  `dtype` casts every
    tensor (default: the reference's own dtype)."""
    out = {k: _tensor(ref[k], device, dtype)
           for k in ("embed", "unembed", "ln_f")}
    out["prologue"] = [_tree(p, device, dtype) for p in ref["prologue"]]
    out["pattern"] = []
    for stacked in ref["pattern"]:
        whole = _tree(stacked, device, dtype)
        n_repeats = _first_leaf(whole).shape[0]
        out["pattern"].append([_unstack(whole, r) for r in range(n_repeats)])
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree
