"""The typed op-graph IR a plan executes over (ir.py)."""
from repro_torch.graph.ir import (SEGMENT_EXCLUSIVE, SEGMENT_FUSED,
                                  SEGMENT_POOL, Graph, Node, Segment,
                                  from_units)

__all__ = ["Graph", "Node", "SEGMENT_EXCLUSIVE", "SEGMENT_FUSED",
           "SEGMENT_POOL", "Segment", "from_units"]
