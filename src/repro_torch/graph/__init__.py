"""The typed op-graph IR a plan executes over (ir.py)."""
from repro_torch.graph.ir import Graph, Node, from_units

__all__ = ["Graph", "Node", "from_units"]
