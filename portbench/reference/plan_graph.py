"""A compiled plan's network run plainly: every node unsplit, in fp32.

What a plan computes does not depend on how it is split: a conv node is
the SAME convolution of its (1, H, W, C_in) input with its (K, K, C_in,
C_out) filter at stride S, cropped to (H // S, W // S) (XLA's SAME
geometry: the smaller half of the padding first); a pool node max-pools
down to the edge its recorded fp32 output bytes give, in windows of
H // edge, or at edge 1 takes the mean over the image; a linear node is
x @ W with W (C_in, C_out), x the previous activation flattened in its
(H, W, C) order.  Neither bias nor activation function: the plan's units
carry none.  The reference walks the nodes the benchmark reads from the
frozen artifact (`counts.plan_nodes`), not the program's graph, and
refuses a network whose shapes do not chain.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from portbench.counts import pool_edge
from portbench.reference.precision import EXACT, Precision


def weight_shape(node: Dict[str, Any]):
    op = node["op"]
    if node["kind"] == "linear":
        return (op["C_in"], op["C_out"])
    if node["kind"] == "conv":
        return (op["K"], op["K"], op["C_in"], op["C_out"])
    raise ValueError(f"node {node['id']} ({node['kind']}) has no weight")


def fan_in(node: Dict[str, Any]) -> int:
    shape = weight_shape(node)
    return math.prod(shape[:-1])


def input_shape(node: Dict[str, Any]):
    """The network's input: one (H, W, C_in) image, or (L, C_in) rows."""
    op = node["op"]
    if node["kind"] == "conv":
        return (1, op["H_in"], op["W_in"], op["C_in"])
    return (op["L"], op["C_in"])


def _same_pads(n: int, k: int, s: int):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, op: Dict[str, int],
         prec: Precision) -> torch.Tensor:
    s = op["S"]
    ph = _same_pads(op["H_in"], op["K"], s)
    pw = _same_pads(op["W_in"], op["K"], s)
    xn = F.pad(prec.operand(x).permute(0, 3, 1, 2),
               (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, prec.operand(w).permute(3, 2, 0, 1), stride=s)
    y = y.permute(0, 2, 3, 1)
    return y[:, :max(1, op["H_in"] // s), :max(1, op["W_in"] // s), :]


def pool(x: torch.Tensor, pool_bytes: int) -> torch.Tensor:
    _, h, w, c = x.shape
    edge = pool_edge(pool_bytes, c)
    if edge == 1:
        return x.mean(dim=(1, 2), keepdim=True)
    if h % edge or w % edge:
        raise ValueError(f"a ({h}, {w}) image does not pool evenly to "
                         f"{edge}")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=h // edge)
    return y.permute(0, 2, 3, 1)


def run(nodes: List[Dict[str, Any]], weights: Dict[str, torch.Tensor],
        x: torch.Tensor, prec: Precision = EXACT) -> torch.Tensor:
    """The output of the chain of `nodes` for input x."""
    act = x.float()
    for node in nodes:
        kind, op = node["kind"], node.get("op")
        if len(node["inputs"]) > 1:
            raise ValueError(f"node {node['id']} joins several inputs")
        if kind == "conv":
            want = (1, op["H_in"], op["W_in"], op["C_in"])
            if tuple(act.shape) != want:
                raise ValueError(f"{node['id']}: input {tuple(act.shape)}"
                                 f" does not chain to {want}")
            act = conv(act, weights[node["id"]], op, prec)
        elif kind == "pool":
            act = pool(act, node["pool_bytes"])
        elif kind == "linear":
            if act.numel() != op["L"] * op["C_in"]:
                raise ValueError(f"{node['id']}: {act.numel()} values do "
                                 f"not chain to ({op['L']}, {op['C_in']})")
            act = torch.matmul(prec.operand(act.reshape(op["L"],
                                                        op["C_in"])),
                               prec.operand(weights[node["id"]]))
        else:
            raise ValueError(f"node {node['id']}: kind {kind!r}")
    return act
