"""The measurement schema: one record per executed unit.

The port's copy of `repro.measure.record.MeasurementRecord`, field for
field, so an executed run of the port serializes to the same JSON record
as the reference's: what ran (op kind and shape through the registry
codec, the split, the mode, the chain/gather flags), the measurement
(`wall_us` observed against the plan's `pred_us`), and its provenance.
On the port, `device` keeps the plan's simulated target device, `backend`
names the torch device that ran the unit (or the simulated backend of a
simulator record) and `host` the machine.  Records round-trip through
JSON unchanged (floats in repr-shortest form), so a JSONL file either
package's `MeasurementStore` wrote loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.types import Op
from repro_torch.kernels.registry import (op_from_json, op_kind, op_label,
                                          op_to_json)

MEASUREMENT_SCHEMA_VERSION = 1

#: record sources
SOURCE_EXECUTOR = "executor"      # wall-clock timed plan execution
SOURCE_SIMULATOR = "simulator"    # analytic device-model measurement
SOURCE_FUSED = "fused"            # segment-walk execution: per-node wall is
                                  # the segment wall attributed pro-rata by
                                  # predicted latency

#: execution modes (executor) + the simulator's pseudo-mode
MODE_COEXEC = "coexec"
MODE_EXCLUSIVE = "exclusive"
MODE_POOL = "pool"
MODE_ADD = "add"
MODE_SIMULATED = "simulated"


@dataclasses.dataclass
class MeasurementRecord:
    """Executed (or simulated) vs predicted record for one measured unit."""

    index: int                   # schedule position (or batch index)
    unit: str                    # "conv"|"linear"|"attention"|"ssm"|"pool"|"add"
    label: str
    mode: str                    # coexec | exclusive | pool | add | simulated
    c_fast: int                  # GPU-analogue channel share (0 = unsplit)
    c_slow: int                  # CPU-analogue channel share
    chained_input: bool          # consumed the producer's group-local parts
    gathered_output: bool        # output materialized (reshard point)
    wall_us: float               # observed latency
    pred_us: float               # predicted latency (0 = none)
    op: Optional[Op] = None
    source: str = SOURCE_EXECUTOR
    device: str = ""
    backend: str = ""
    host: str = ""
    plan_key: str = ""
    network_fingerprint: str = ""
    node_id: str = ""
    segment: int = -1
    schema_version: int = MEASUREMENT_SCHEMA_VERSION

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["op"] = None if self.op is None else op_to_json(self.op)
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "MeasurementRecord":
        d = dict(d)
        if d.get("op") is not None:
            d["op"] = op_from_json(d["op"])
        return MeasurementRecord(**d)


def usable_for_fidelity(record: MeasurementRecord) -> bool:
    """The reference's fidelity filter: a record counts iff its wall and
    prediction are both positive and it is not a pool unit."""
    return (record.wall_us > 0.0 and record.pred_us > 0.0
            and record.unit != "pool")



def record_for_op(op: Op, *, index: int = 0, wall_us: float, pred_us: float,
                  mode: str = MODE_SIMULATED, source: str = SOURCE_SIMULATOR,
                  device: str = "", backend: str = "", host: str = "",
                  plan_key: str = "", network_fingerprint: str = ""
                  ) -> MeasurementRecord:
    """Build a record for a bare op (kind and label via the registry)."""
    return MeasurementRecord(
        index=index, unit=op_kind(op), label=op_label(op), mode=mode,
        c_fast=0, c_slow=0, chained_input=False, gathered_output=True,
        wall_us=float(wall_us), pred_us=float(pred_us), op=op,
        source=source, device=device, backend=backend, host=host,
        plan_key=plan_key, network_fingerprint=network_fingerprint)
