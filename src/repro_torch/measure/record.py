"""The measurement schema: one record per executed unit.

The port's copy of `repro.measure.record.MeasurementRecord`, field for
field, so an executed run of the port serializes to the same JSON record
shape as the reference's: what ran (op kind and shape through the
registry codec, the split, the mode, the chain/gather flags), the
measurement (`wall_us` observed against the plan's `pred_us`), and its
provenance.  On the port, `device` keeps the plan's simulated target
device, `backend` names the torch device that ran the unit and `host` the
machine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, Optional

from repro_torch.core.types import Op
from repro_torch.kernels.registry import op_from_json, op_to_json

MEASUREMENT_SCHEMA_VERSION = 1

#: record sources
SOURCE_EXECUTOR = "executor"      # wall-clock timed plan execution
SOURCE_FUSED = "fused"            # segment-walk execution: per-node wall is
                                  # the segment wall attributed pro-rata by
                                  # predicted latency

#: execution modes
MODE_COEXEC = "coexec"
MODE_EXCLUSIVE = "exclusive"
MODE_POOL = "pool"
MODE_ADD = "add"


@dataclasses.dataclass
class MeasurementRecord:
    """Executed-vs-predicted record for one measured unit."""

    index: int                   # schedule position
    unit: str                    # "conv"|"linear"|"attention"|"ssm"|"pool"|"add"
    label: str
    mode: str                    # coexec | exclusive | pool | add
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


def fidelity_error(records: Iterable[MeasurementRecord]) -> float:
    """Σ |log(wall/pred)| over usable records (the reference's
    uncalibrated `repro.measure.calibrate.fidelity_error`)."""
    return sum(abs(math.log(r.wall_us / r.pred_us)) for r in records
               if usable_for_fidelity(r))
