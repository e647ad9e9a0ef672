"""Dependency-free checkpoints of trees of tensors, in the reference's
format (`repro.checkpoint.store`).

Layout: <dir>/<step>/manifest.json + one .npy per leaf, keyed by the leaf's
path in the tree spelled as the reference's `_flatten` spells a JAX key
path: a dict key k as `__k__` (`['k']` with every character but word
characters and dots made `_`), a list index i as `_i_`, a NamedTuple
field f as `.f`, joined by `/`; dict keys in sorted order, as JAX
flattens them.  bfloat16 leaves are stored as uint16 views with the
dtype tag "bfloat16" (numpy has no bf16 of its own): the bits go through
torch's int16 view, never through a numpy bf16 dtype, so no `ml_dtypes`
is needed.  Model params are saved in the reference's layout
(`repro_torch.models.params_to_reference`), so a checkpoint written by
either package loads in the other.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _key(entry) -> str:
    return re.sub(r"[^\w.]", "_", entry)


def _paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], prefix + (_key(f"[{k!r}]"),))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _paths(getattr(tree, f), prefix + (f".{f}",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _paths(v, prefix + (_key(f"[{i}]"),))
        return out
    return [("/".join(prefix), tree)]


def _flatten(tree) -> Dict[str, Any]:
    return dict(_paths(tree))


def _unflatten(tree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (_key(f"[{k!r}]"),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, prefix + (_key(f"[{i}]"),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf (a tensor, or anything numpy takes) as the array to save
    and its dtype tag."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(directory, step: int, tree) -> Path:
    out = Path(directory) / str(step)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for key, leaf in _flatten(tree).items():
        arr, tag = _to_numpy(leaf)
        fname = f"{abs(hash(key)) % 10**12}.npy"
        np.save(out / fname, arr)
        manifest[key] = {"file": fname, "dtype": tag}
    with open(out / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    return out


def restore_checkpoint(directory, step: int, template):
    """Restore into the structure of `template` (the same tree shape; its
    leaves are not read).  Every leaf comes back as a CPU tensor of its
    saved dtype, bf16 included."""
    src = Path(directory) / str(step)
    with open(src / "manifest.json") as f:
        manifest = json.load(f)
    restored = {}
    for key in _flatten(template):
        meta = manifest[key]
        arr = np.load(src / meta["file"])
        if meta["dtype"] == "bfloat16":
            restored[key] = torch.from_numpy(
                arr.view(np.int16)).view(torch.bfloat16)
        else:
            restored[key] = torch.from_numpy(arr)
    return _unflatten(template, restored)


def latest_step(directory) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name) for p in d.iterdir() if p.name.isdigit()]
    return max(steps) if steps else None
