"""Named-axis sharding rules for parameters, optimizer state, batches and
KV caches: the port's counterpart of `repro.sharding.rules`.

Rules are regex patterns over flattened parameter paths, each giving a
PartitionSpec *anchored at the trailing dimensions* of the leaf; leading
stack axes are padded with None.  After rule lookup every spec is
*sanitized*: an axis that does not evenly divide its dimension is dropped
(replicated), so any (config x mesh) combination gets a spec.

The rule table is the reference's, in its order.  The port keeps one
leaf per layer (`models/weights.py`) where the reference stacks layers
over a leading axis, and the table reads the two layouts differently in
one place: the MoE rules (anchor rank 3) come before the dense FFN rules,
so a reference *stacked* dense FFN leaf such as codeqwen1.5-7b's
`pattern/0/ffn/w_gate` (32, 4096, 13440) takes the MoE spec
("model", "data", None), while the port's per-layer (4096, 13440) leaf
takes the dense one ("data", "model").

A spec is a `PartitionSpec`, a tuple (it compares equal to
`tuple(jax.sharding.PartitionSpec(...))`), and a sharding a
`NamedSharding` of a mesh and a spec.  `shard_params` places a tree by
its shardings, the counterpart of `jax.device_put(params, shardings)`:
the port runs on one device, so it places every leaf there, and it
raises for a mesh it cannot run on.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional, Tuple

from repro_torch.core.tree import tree_map
from repro_torch.launch.mesh import Mesh

# (path regex, min ndim of the anchored spec, trailing spec)
_PARAM_RULES: Tuple[Tuple[str, int, Tuple], ...] = (
    (r"embed$", 2, ("model", "data")),
    (r"unembed$", 2, ("data", "model")),
    # --- MoE (must precede generic ffn rules; leaves are 3D E,.,.) ---
    (r"ffn/router$", 2, (None, None)),
    (r"(ffn|moe)/w_gate$", 3, ("model", "data", None)),
    (r"(ffn|moe)/w_up$", 3, ("model", "data", None)),
    (r"(ffn|moe)/w_down$", 3, ("model", None, "data")),
    (r"shared/w_gate$", 2, ("data", "model")),
    (r"shared/w_up$", 2, ("data", "model")),
    (r"shared/w_down$", 2, ("model", "data")),
    # --- MLA ---
    (r"attn/wq$", 2, ("data", "model")),
    (r"w_dkv$", 2, ("data", "model")),
    (r"w_krope$", 2, ("data", None)),
    (r"w_uk$", 3, (None, "model", None)),
    (r"w_uv$", 3, (None, "model", None)),
    # --- attention ---
    (r"(attn|self_attn|cross_attn)/w[kv]$", 2, ("data", "model")),
    (r"(attn|self_attn|cross_attn)/b[qkv]$", 1, ("model",)),
    (r"(attn|self_attn|cross_attn|tm)/wo$", 2, ("model", "data")),
    # --- dense mlp ---
    (r"(ffn|mlp)/w_gate$", 2, ("data", "model")),
    (r"(ffn|mlp)/w_up$", 2, ("data", "model")),
    (r"(ffn|mlp)/w_down$", 2, ("model", "data")),
    # --- rwkv ---
    (r"tm/w[rkvg]$", 2, ("data", "model")),
    (r"cm/wk$", 2, ("data", "model")),
    (r"cm/wv$", 2, ("model", "data")),
    # --- mamba ---
    (r"mixer/w_in$", 2, ("data", "model")),
    (r"mixer/w_out$", 2, ("model", "data")),
)


def _canonical(part):
    """A spec entry as jax canonicalizes it: a tuple of axis names, one
    name for a 1-tuple, None for an empty one."""
    if isinstance(part, (tuple, list)):
        return None if not part else part[0] if len(part) == 1 \
            else tuple(part)
    return part


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), an axis name, or a
    tuple of axis names, canonical as in jax."""

    def __new__(cls, *parts):
        return super().__new__(cls, map(_canonical, parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _with_path(fn, tree, path=()):
    """`fn(path, leaf)` over the leaves of nested dicts, lists and tuples,
    in a tree of `tree`'s shape; a path is the keys and list indices down
    to the leaf."""
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _axis_size(axis, mesh: Mesh) -> int:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return math.prod(mesh.shape[a] for a in axes)


def sanitize(spec: Tuple, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Drop axes that don't divide the dim; never shard size-1 dims."""
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            out.append(None)
            continue
        size = _axis_size(axis, mesh)
        out.append(axis if dim % size == 0 and dim >= size and size > 1
                   else None)
    return P(*out)


def param_spec(path, leaf, mesh: Mesh) -> P:
    ps = _path_str(path)
    nd = leaf.ndim
    for pat, anchor_nd, tail in _PARAM_RULES:
        if re.search(pat, ps) and nd >= anchor_nd:
            spec = (None,) * (nd - len(tail)) + tail
            return sanitize(spec, tuple(leaf.shape), mesh)
    return P(*([None] * nd))                 # norms, scalars, biases


def param_shardings(params, mesh: Mesh):
    """A NamedSharding tree for a params (or congruent moment) tree."""
    return _with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(path, leaf, mesh)),
        params)


def batch_axes(mesh: Optional[Mesh]):
    """The axes a batch is split over: ('pod','data') on the multi-pod
    mesh, else ('data',)."""
    if mesh is not None and "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)


def batch_spec(batch_size: int, mesh: Mesh) -> P:
    axes = batch_axes(mesh)
    size = _axis_size(axes, mesh)
    if batch_size % size == 0 and batch_size >= size:
        return P(axes)
    if batch_size % mesh.shape["data"] == 0:
        return P("data")
    return P(None)


def batch_shardings(batch, mesh: Mesh):
    """Shard dim 0 (batch) of every batch leaf."""
    def spec(leaf):
        s = batch_spec(leaf.shape[0], mesh)
        return NamedSharding(mesh, P(*(tuple(s) + (None,) *
                                       (leaf.ndim - 1))))
    return tree_map(spec, batch)


def cache_spec(path, leaf, mesh: Mesh, *, batch: int,
               seq_shard: bool) -> P:
    """KV-cache leaf sharding.

    Layout conventions (see models/*): trailing dims are one of
      (B, S, kv, hd) attention cache   (possibly with leading stack dims)
      (B, S, r)      MLA latent cache
      (B, H, hd, N)  ssm state; (B, K-1, C) conv carry; (B, D) shift carry
    """
    ps = _path_str(path)
    nd = leaf.ndim
    shape = tuple(leaf.shape)
    b_ax = batch_spec(batch, mesh)
    b_entry = tuple(b_ax)[0] if tuple(b_ax) else None
    s_entry = "data" if (seq_shard and b_entry is None) else None

    if re.search(r"(wkv|ssm)", ps) and nd >= 4:          # (B,H,hd,N)-like
        tail = (b_entry, "model", None, None)
    elif re.search(r"(conv|x_tm|x_cm)", ps):
        tail = (b_entry,) + (None,) * (min(nd, 3) - 1)
    elif re.search(r"enc$", ps):
        tail = (b_entry, None, "model")
    elif nd >= 4:                                        # (B,S,kv,hd)
        kv, hd = shape[-2], shape[-1]
        m = mesh.shape["model"]
        if kv % m == 0:                                  # shard kv heads
            tail = (b_entry, s_entry, "model", None)
        elif hd % m == 0:                                # shard head_dim
            tail = (b_entry, s_entry, None, "model")
        else:
            tail = (b_entry, s_entry, None, None)
    elif nd == 3:                                        # (B,S,r) latent
        tail = (b_entry, s_entry, "model")
    else:
        tail = (b_entry,) + (None,) * (nd - 1)
    tail = tail[:nd]
    spec = (None,) * (nd - len(tail)) + tail
    return sanitize(spec, shape, mesh)


def cache_shardings(cache, mesh: Mesh, *, batch: int,
                    seq_shard: bool = False):
    return _with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_spec(path, leaf, mesh, batch=batch,
                             seq_shard=seq_shard)),
        cache)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_bytes(leaf, sharding: NamedSharding) -> int:
    """The bytes of one device's shard of `leaf` (a sanitized spec keeps
    only axes that divide their dimension)."""
    return leaf.numel() * leaf.element_size() // math.prod(
        _axis_size(a, sharding.mesh) for a in sharding.spec if a is not None)


def require_devices(mesh: Mesh) -> None:
    """Raise unless this process can run on `mesh`: the port runs one
    process on one device."""
    if mesh.devices is None or mesh.size != 1:
        raise RuntimeError(
            f"the {' x '.join(mesh.axis_names)} mesh needs "
            f"{' x '.join(str(s) for s in mesh.sizes)} = {mesh.size} "
            f"devices; this process runs on 1")


def shard_params(tree, shardings) -> Any:
    """`tree` placed by `shardings` (a congruent NamedSharding tree): the
    counterpart of `jax.device_put(tree, shardings)`.  On a one-device
    mesh every leaf moves to that device (a leaf already there is kept as
    it is); a mesh this process cannot run on raises."""
    def place(leaf, sharding):
        require_devices(sharding.mesh)
        return leaf.to(sharding.mesh.devices[0])
    return tree_map(place, tree, shardings)
