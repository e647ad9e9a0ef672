"""Walks over the port's parameter trees: nested dicts, lists and tuples
whose leaves are tensors (or arrays).  Models, the optimizer, the train
step and the weight carry-over share these; the checkpoint store keeps
its own walk, which spells each leaf's key path as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_leaves(tree) -> Iterator[Any]:
    """The leaves of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the same places of `rest`, in a
    tree of `tree`'s shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
