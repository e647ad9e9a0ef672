"""Operations and bytes of the work a configuration defines, from its
shapes alone: the yardstick of every roofline and `mfu` share.

Each count is what the operation needs, not what a kernel happens to do:
every input byte read once and every output byte written once.  A kernel
that recomputes, re-reads or runs padded tiles does more than this, so
its share is lower, never higher: a correct kernel cannot read over
100 %.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

#: the kinds of work that make up a request (what `mfu` adds up); other
#: kinds a driver reports recount part of this work as one kernel sees it
STEP_KINDS = ("linear", "conv", "pool")


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def seconds(self, peak_flops: float, peak_bytes: float) -> float:
        """The least time the card could take: the larger of the two
        bounds."""
        return max(self.flops / peak_flops, self.bytes / peak_bytes)


def total(works: List[Work]) -> Work:
    return Work(sum(w.flops for w in works), sum(w.bytes for w in works))


def product(m: int, k: int, n: int, elt: int) -> Work:
    """(m, k) @ (k, n) with elements of `elt` bytes."""
    return Work(2.0 * m * k * n, float(elt) * (m * k + k * n + m * n))


def conv(op: Dict[str, int], elt: int) -> Work:
    """A K x K convolution of one (H, W, C_in) image to (H_out, W_out,
    C_out), H_out = H // S: 2 K^2 C_in operations per output element;
    the image, the filter and the output moved once."""
    h, w, cin, cout, k, s = (op["H_in"], op["W_in"], op["C_in"],
                             op["C_out"], op["K"], op["S"])
    out = max(1, h // s) * max(1, w // s) * cout
    return Work(2.0 * k * k * cin * out,
                float(elt) * (h * w * cin + k * k * cin * cout + out))


def pool(h: int, w: int, c: int, edge: int, elt: int) -> Work:
    """Max pooling of (H, W, C) to (edge, edge, C) over r x r windows,
    r = H // edge (one comparison per input element read), or, at edge 1,
    the mean over the whole image."""
    read = h * w * c if edge == 1 else (h // edge) * (w // edge) * \
        edge * edge * c
    return Work(float(read), float(elt) * (read + edge * edge * c))


# --------------------------------------------- the Winograd product
def winograd_eligible(op: Dict[str, int]) -> bool:
    """Whether a conv takes F(2x2, 3x3) Winograd (the paper's kernel
    selection, Section 3.2, as `repro_torch.kernels.winograd_conv`
    applied it at commit b5c5839): 3x3, stride 1, at least 128 output and
    32 input channels, at least 1024 pixels."""
    return (op["K"] == 3 and op["S"] == 1 and op["C_out"] >= 128
            and op["H_in"] * op["W_in"] >= 1024 and op["C_in"] >= 32)


def hadamard_product(op: Dict[str, int], elt: int) -> Work:
    """The Winograd-domain product of an F(2x2, 3x3) conv, what
    `hadamard_matmul` computes: 16 products (P, C_in) @ (C_in, C_out),
    P = ceil(H/2) ceil(W/2) output tiles; U, V and M moved once."""
    p = -(-op["H_in"] // 2) * -(-op["W_in"] // 2)
    one = product(p, op["C_in"], op["C_out"], elt)
    return Work(16 * one.flops, 16 * one.bytes)


# ----------------------------------------------------------------- plans
def plan_nodes(artifact: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The nodes of a unit-chain artifact, in order: one node per schedule
    entry, `n<i>` fed by `n<i-1>`, as the program lowers a unit chain.
    An artifact that carries a graph of its own is refused."""
    plan = artifact["plan"]
    if "graph" in plan:
        raise ValueError("the artifact is a graph, not a unit chain")
    nodes: List[Dict[str, Any]] = []
    for i, entry in enumerate(plan["schedule"]):
        node: Dict[str, Any] = {"id": f"n{i}", "kind": entry["unit"],
                                "inputs": [f"n{i - 1}"] if i else []}
        if entry["unit"] == "pool":
            node["pool_bytes"] = int(entry["bytes"])
        else:
            node["op"] = {k: v for k, v in entry["decision"]["op"].items()
                          if k != "kind"}
        nodes.append(node)
    return nodes


def pool_edge(pool_bytes: int, c: int) -> int:
    """A pool node's output edge from its recorded fp32 output bytes
    (4 edge^2 C)."""
    return max(1, math.isqrt(max(1, pool_bytes // (4 * c))))


def plan_request(artifact: Dict[str, Any], elt: int = 4
                 ) -> Dict[str, List[Work]]:
    """One request of a plan of conv, pool and linear nodes, by node kind,
    and `hadamard`: the Winograd product of each conv that takes it."""
    out: Dict[str, List[Work]] = {k: [] for k in STEP_KINDS}
    out["hadamard"] = []
    shape = None                                  # (H, W, C) flowing on
    for node in plan_nodes(artifact):
        op, kind = node.get("op"), node["kind"]
        if kind == "conv":
            out["conv"].append(conv(op, elt))
            if winograd_eligible(op):
                out["hadamard"].append(hadamard_product(op, elt))
            shape = (max(1, op["H_in"] // op["S"]),
                     max(1, op["W_in"] // op["S"]), op["C_out"])
        elif kind == "linear":
            out["linear"].append(product(op["L"], op["C_in"], op["C_out"],
                                         elt))
            shape = None
        elif kind == "pool":
            h, w, c = shape
            edge = pool_edge(node["pool_bytes"], c)
            out["pool"].append(pool(h, w, c, edge, elt))
            shape = (edge, edge, c)
        else:
            raise ValueError(f"node {node['id']}: kind {kind!r} is not "
                             f"counted")
    return out
