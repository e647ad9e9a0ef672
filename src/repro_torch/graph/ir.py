"""The typed op graph a plan executes over.

The port's copy of `repro.graph.ir`, cut to what planning and execution
need:

  * `Node(id, kind, op, inputs)` — one scheduling unit.  `kind` is either
    a kernel-registry op kind ("conv", "linear", "attention", "ssm") with
    its `op` payload, or a structural kind: "pool" (carries `pool_bytes`)
    and "add" (elementwise residual join, >= 2 inputs).
  * `Graph` — validated, topologically ordered, shape-inferred and
    JSON-serializable (the reference's codec, key for key).  Edges are
    explicit, so the executor gathers a shared split output once and
    elides the gather where the sole consumer is a compatible split node
    (`Graph.elided`).
  * `Graph.segments(coexec)` — the reference's segment partition: the
    topological order cut into maximal fused runs of channel-split nodes
    and residual adds, and pool/exclusive singletons
    (`runtime/segments.py` runs each fused run as one program).
  * `fingerprint()` — the reference's content-addressed digest, byte for
    byte: a loaded plan is checked against its provenance with it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import (Any, Collection, Dict, FrozenSet, Iterator, List,
                    Optional, Sequence, Tuple)

from repro_torch.core.networks import Unit, pool_out_edge
from repro_torch.core.types import Op
from repro_torch.kernels import registry

#: the reference's graph schema version (enters DAG fingerprints)
GRAPH_SCHEMA_VERSION = 2

#: node kinds with no kernel-registry op payload
STRUCTURAL_KINDS = ("pool", "add")

#: segment kinds: "fused" runs as one program (one CUDA graph on the card),
#: the others are per-node eager singletons (true dispatch boundaries)
SEGMENT_FUSED = "fused"
SEGMENT_POOL = "pool"
SEGMENT_EXCLUSIVE = "exclusive"


@dataclasses.dataclass(frozen=True)
class Node:
    """One scheduling unit of the op graph.

    `inputs` name the producing nodes.  A node with no inputs is a source:
    it reads the graph input.  Op-kind nodes take at most one input,
    "pool" exactly one, "add" at least two.
    """

    id: str
    kind: str
    op: Optional[Op] = None
    pool_bytes: int = 0
    inputs: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.id or not isinstance(self.id, str):
            raise ValueError(f"node id must be a non-empty string, "
                             f"got {self.id!r}")
        object.__setattr__(self, "inputs", tuple(self.inputs))
        if self.kind in STRUCTURAL_KINDS:
            if self.op is not None:
                raise ValueError(f"node {self.id!r}: structural kind "
                                 f"{self.kind!r} carries no op")
            if self.kind == "pool":
                if self.pool_bytes <= 0:
                    raise ValueError(
                        f"node {self.id!r}: pool needs a positive byte "
                        f"count, got {self.pool_bytes}")
                if len(self.inputs) != 1:
                    raise ValueError(f"node {self.id!r}: pool takes exactly "
                                     f"one input, got {len(self.inputs)}")
            elif len(self.inputs) < 2:
                raise ValueError(f"node {self.id!r}: add joins >= 2 inputs, "
                                 f"got {len(self.inputs)}")
            return
        entry = registry.get(self.kind)      # raises on unknown kinds
        if self.op is None:
            raise ValueError(f"node {self.id!r}: kind {self.kind!r} needs "
                             f"an op payload")
        if registry.op_kind(self.op) != entry.kind:
            raise ValueError(
                f"node {self.id!r}: op is {registry.op_kind(self.op)!r} "
                f"but the node kind is {self.kind!r}")
        if len(self.inputs) > 1:
            raise ValueError(f"node {self.id!r}: op nodes take at most one "
                             f"input, got {len(self.inputs)}")

    @property
    def splittable(self) -> bool:
        """Whether the partitioner may channel-split this node."""
        return self.op is not None and registry.get(self.kind).splittable

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"id": self.id, "kind": self.kind,
                             "inputs": list(self.inputs)}
        if self.op is not None:
            d["op"] = registry.op_to_json(self.op)
        if self.kind == "pool":
            d["bytes"] = self.pool_bytes
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Node":
        return Node(id=d["id"], kind=d["kind"],
                    op=(registry.op_from_json(d["op"])
                        if d.get("op") is not None else None),
                    pool_bytes=int(d.get("bytes", 0)),
                    inputs=tuple(d.get("inputs", ())))


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous run of a segment partition (see `Graph.segments`):
    a "fused" run of co-executed nodes and residual adds, or a "pool" or
    "exclusive" singleton."""

    kind: str                           # fused | pool | exclusive
    node_ids: Tuple[str, ...]

    def __post_init__(self):
        if self.kind not in (SEGMENT_FUSED, SEGMENT_POOL,
                             SEGMENT_EXCLUSIVE):
            raise ValueError(f"unknown segment kind {self.kind!r}")
        if not self.node_ids:
            raise ValueError("a segment needs at least one node")
        object.__setattr__(self, "node_ids", tuple(self.node_ids))

    def __len__(self) -> int:
        return len(self.node_ids)


class Graph:
    """A validated, topologically ordered op graph.

    Construction validates the node set (unique ids, known kinds, arity,
    existing inputs, acyclicity, exactly one output node) and orders the
    nodes with the reference's deterministic Kahn walk (always the
    earliest *given* ready node), so both packages agree on positions.
    """

    def __init__(self, nodes: Sequence[Node]):
        given = list(nodes)
        if not given:
            raise ValueError("a graph needs at least one node")
        by_id: Dict[str, Node] = {}
        for n in given:
            if n.id in by_id:
                raise ValueError(f"duplicate node id {n.id!r}")
            by_id[n.id] = n
        consumers: Dict[str, List[str]] = {n.id: [] for n in given}
        for n in given:
            for src in n.inputs:
                if src not in by_id:
                    raise ValueError(f"node {n.id!r} consumes unknown node "
                                     f"{src!r}")
                if src == n.id:
                    raise ValueError(f"node {n.id!r} consumes itself")
                consumers[src].append(n.id)
        outputs = [n.id for n in given if not consumers[n.id]]
        if len(outputs) != 1:
            raise ValueError(
                f"a graph needs exactly one output node (no consumers); "
                f"got {outputs}")

        emitted: Dict[str, int] = {}
        order: List[Node] = []
        while len(order) < len(given):
            progressed = False
            for n in given:
                if n.id in emitted:
                    continue
                if all(src in emitted for src in n.inputs):
                    emitted[n.id] = len(order)
                    order.append(n)
                    progressed = True
            if not progressed:
                cyclic = sorted(set(by_id) - set(emitted))
                raise ValueError(f"graph has a cycle through {cyclic}")

        self.nodes: Tuple[Node, ...] = tuple(order)
        self._by_id = by_id
        self._consumers = {nid: tuple(c) for nid, c in consumers.items()}
        self._out_shapes: Dict[str, Tuple[int, ...]] = {}

    # ----------------------------------------------------------- accessors
    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes)

    def node(self, node_id: str) -> Node:
        try:
            return self._by_id[node_id]
        except KeyError:
            raise KeyError(f"no node {node_id!r}; "
                           f"ids: {[n.id for n in self.nodes]}") from None

    def consumers(self, node_id: str) -> Tuple[str, ...]:
        """Ids of the nodes consuming `node_id`'s output."""
        self.node(node_id)
        return self._consumers[node_id]

    def sole_consumer(self, node_id: str) -> Optional[Node]:
        """The single consumer of a node's output, or None on fan-out /
        graph output — the gather-elision predicate's first half."""
        cons = self.consumers(node_id)
        if len(cons) != 1:
            return None
        return self._by_id[cons[0]]

    @property
    def output(self) -> Node:
        # every node feeds the unique sink, so the sink is last in order
        return self.nodes[-1]

    @property
    def sources(self) -> Tuple[Node, ...]:
        return tuple(n for n in self.nodes if not n.inputs)

    def splittable_nodes(self) -> List[Node]:
        """The partitioner's domain: channel-splittable op nodes."""
        return [n for n in self.nodes if n.splittable]

    # ----------------------------------------------------- shape inference
    def input_shape(self, node_id: str) -> Optional[Tuple[int, ...]]:
        """Declared input shape of an op node (None for pool/add)."""
        n = self.node(node_id)
        if n.op is None:
            return None
        return tuple(registry.get(n.kind).input_shape(n.op))

    def output_shape(self, node_id: str) -> Tuple[int, ...]:
        """Inferred output shape of a node: op nodes declare theirs, pool
        recovers its edge from the recorded byte count and the producer's
        channels, add emits its producers' (equal) shape."""
        if node_id in self._out_shapes:
            return self._out_shapes[node_id]
        n = self.node(node_id)
        if n.op is not None:
            shape = tuple(registry.get(n.kind).output_shape(n.op))
        elif n.kind == "pool":
            prev = self.output_shape(n.inputs[0])
            c_prev = int(prev[-1])
            edge = pool_out_edge(n.pool_bytes, c_prev)
            shape = (edge, edge, c_prev)
        else:                                   # add
            shapes = {self.output_shape(src) for src in n.inputs}
            if len(shapes) != 1:
                raise ValueError(
                    f"add node {n.id!r} joins mismatched shapes "
                    f"{sorted(shapes)}")
            shape = shapes.pop()
        self._out_shapes[node_id] = shape
        return shape

    def check_shapes(self) -> None:
        """Strict edge validation, as the reference's: every op node's
        declared input shape equals its producer's inferred output shape
        (legacy unit chains are not held to it; `from_model` graphs pass
        it).  Attention/ssm ops are charged per sequence, so an edge
        touching one may carry a whole batch of rows: trailing dims must
        match and the leading dims must divide."""
        for n in self.nodes:
            self.output_shape(n.id)             # forces add-join checks
            declared = self.input_shape(n.id)
            if declared is None or not n.inputs:
                continue
            src = self.node(n.inputs[0])
            produced = self.output_shape(n.inputs[0])
            if tuple(produced) == tuple(declared):
                continue
            per_seq = n.kind in ("attention", "ssm") or \
                src.kind in ("attention", "ssm")
            a, b = tuple(produced), tuple(declared)
            if per_seq and len(a) == len(b) and a[1:] == b[1:] and \
                    min(a[0], b[0]) > 0 and max(a[0], b[0]) % \
                    min(a[0], b[0]) == 0:
                continue
            raise ValueError(
                f"edge {n.inputs[0]!r} -> {n.id!r}: producer emits "
                f"{tuple(produced)} but the consumer declares "
                f"{tuple(declared)}")

    # ------------------------------------------- gather elision, segments
    def _chains_edge(self, producer: Node, consumer: Node) -> bool:
        """Whether the producer->consumer edge can stay group-local: the
        consumer declares exactly the producer's output shape."""
        declared = self.input_shape(consumer.id)
        if declared is None:
            return consumer.kind == "add"
        return tuple(self.output_shape(producer.id)) == tuple(declared)

    def segments(self, coexec: Collection[str]) -> List[Segment]:
        """Partition the topological order into executable segments, as
        the reference does.

        `coexec` names the channel-split nodes.  Fusable nodes (those and
        residual "add" joins) merge into maximal "fused" runs; every other
        node is a "pool" or "exclusive" singleton.  A fused run is cut
        after a node where the per-node walk materializes: fan-out or the
        graph output, a non-fusable sole consumer, or a sole consumer
        whose declared input shape differs from the producer's output.
        A convexity pass then splits any run whose non-final node has a
        consumer outside it, so each run publishes one value.  The
        segments cover `self.nodes` exactly, in order."""
        coexec = frozenset(coexec)

        def fusable(n: Node) -> bool:
            return n.id in coexec or n.kind == "add"

        runs: List[Tuple[str, List[Node]]] = []
        cur: List[Node] = []
        for n in self.nodes:
            if not fusable(n):
                if cur:
                    runs.append((SEGMENT_FUSED, cur))
                    cur = []
                kind = SEGMENT_POOL if n.kind == "pool" else SEGMENT_EXCLUSIVE
                runs.append((kind, [n]))
                continue
            cur.append(n)
            cons = self.consumers(n.id)
            cut = len(cons) != 1
            if not cut:
                nxt = self._by_id[cons[0]]
                cut = not fusable(nxt) or not self._chains_edge(n, nxt)
            if cut:
                runs.append((SEGMENT_FUSED, cur))
                cur = []
        if cur:
            runs.append((SEGMENT_FUSED, cur))

        def convex(run: List[Node]) -> List[List[Node]]:
            ids = {n.id for n in run}
            for i, n in enumerate(run[:-1]):
                if not all(c in ids for c in self.consumers(n.id)):
                    return convex(run[:i + 1]) + convex(run[i + 1:])
            return [run]

        out: List[Segment] = []
        for kind, run in runs:
            parts = convex(run) if kind == SEGMENT_FUSED else [run]
            out += [Segment(kind=kind, node_ids=tuple(n.id for n in part))
                    for part in parts]
        return out

    def elided(self, coexec: Collection[str]) -> FrozenSet[str]:
        """The co-executed nodes whose output stays group-local in the
        chained walk: their sole consumer is a co-executed op node whose
        declared input shape matches exactly (batch-1 activations)."""
        coexec = frozenset(coexec)
        out = set()
        for n in self.nodes:
            if n.id not in coexec:
                continue
            u = self.sole_consumer(n.id)
            if (u is not None and u.id in coexec and u.op is not None
                    and self._chains_edge(n, u)):
                out.add(n.id)
        return frozenset(out)

    def materialization_points(self, coexec: Collection[str]
                               ) -> FrozenSet[str]:
        """The co-executed nodes whose split output must be gathered."""
        coexec = frozenset(coexec)
        return coexec - self.elided(coexec)

    # --------------------------------------------------------- unit compat
    def is_unit_chain(self) -> bool:
        """Whether this graph is exactly a legacy unit list: a linear
        chain of conv/linear/pool nodes."""
        prev: Optional[Node] = None
        for n in self.nodes:
            if n.kind not in ("conv", "linear", "pool"):
                return False
            want = () if prev is None else (prev.id,)
            if n.inputs != want:
                return False
            if prev is not None and len(self._consumers[prev.id]) != 1:
                return False
            prev = n
        return True

    # ---------------------------------------------------------- fingerprint
    def fingerprint(self) -> str:
        """Content-addressed digest of the graph structure, as the
        reference computes it: unit chains digest their legacy unit list,
        other graphs ["graph", schema, [[kind, payload, input positions],
        ...]] with nodes addressed by topological position."""
        if self.is_unit_chain():
            canon: Any = []
            for n in self.nodes:
                if n.kind == "pool":
                    canon.append(["pool", int(n.pool_bytes)])
                else:
                    canon.append([n.kind, registry.op_to_json(n.op)])
        else:
            pos = {n.id: i for i, n in enumerate(self.nodes)}
            canon = ["graph", GRAPH_SCHEMA_VERSION,
                     [[n.kind,
                       (registry.op_to_json(n.op) if n.op is not None
                        else int(n.pool_bytes)),
                       [pos[src] for src in n.inputs]]
                      for n in self.nodes]]
        blob = json.dumps(canon, sort_keys=True, separators=(",", ":"))
        return hashlib.blake2b(blob.encode(), digest_size=12).hexdigest()

    # -------------------------------------------------------------- codecs
    def to_json(self) -> Dict[str, Any]:
        return {"schema_version": GRAPH_SCHEMA_VERSION,
                "nodes": [n.to_json() for n in self.nodes]}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Graph":
        return Graph([Node.from_json(n) for n in d["nodes"]])


def from_units(units: Sequence[Unit]) -> Graph:
    """Lower a legacy unit list into a linear-chain graph with canonical
    position ids ("n0", "n1", ...)."""
    nodes: List[Node] = []
    prev: Tuple[str, ...] = ()
    for i, (kind, payload) in enumerate(units):
        nid = f"n{i}"
        if kind == "pool":
            nodes.append(Node(id=nid, kind="pool",
                              pool_bytes=int(payload), inputs=prev))
        else:
            nodes.append(Node(id=nid, kind=kind, op=payload, inputs=prev))
        prev = (nid,)
    return Graph(nodes)
