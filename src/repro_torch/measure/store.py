"""On-disk measurement store: append-only JSONL, keyed like the plan cache.

The port's copy of the reference's store, file for file.
`MeasurementStore` persists `MeasurementRecord`s under one directory
(default `reports/measurements/`), one file per plan provenance digest,
the same keys `runtime/cache.PlanCache` uses, so a plan's file of
recorded executions is found from its cached plan.  A file either
package wrote loads in the other.

Files are append-only JSONL: every measured run appends one compact JSON
line per record, and nothing ever rewrites history; the accumulated log
is what the `Calibrator` fits on.  Corrupt lines are skipped on load,
never trusted (the plan cache's policy).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

from repro_torch.measure.record import MeasurementRecord

DEFAULT_STORE_DIR = "reports/measurements"

#: store key for records that carry no plan provenance
UNKEYED = "unkeyed"


class MeasurementStore:
    """Append-only JSONL store of measurement records, one file per key."""

    def __init__(self, root: Union[str, Path] = DEFAULT_STORE_DIR):
        self.root = Path(root)

    def path_for(self, key: str) -> Path:
        return self.root / f"{key}.jsonl"

    def append(self, records, key: Optional[str] = None) -> List[Path]:
        """Append records (or an object with `.timings`, e.g. an
        `ExecutionReport`) to the store.

        Without an explicit `key`, each record lands in the file of its
        own `plan_key` (records from different plans may be appended in
        one call).  Returns the paths written to.
        """
        if hasattr(records, "timings"):
            records = records.timings
        by_key: Dict[str, List[MeasurementRecord]] = {}
        for r in records:
            k = key if key is not None else (r.plan_key or UNKEYED)
            by_key.setdefault(k, []).append(r)
        paths = []
        self.root.mkdir(parents=True, exist_ok=True)
        for k, recs in by_key.items():
            path = self.path_for(k)
            with open(path, "a") as f:
                for r in recs:
                    f.write(json.dumps(r.to_json(),
                                       separators=(",", ":")) + "\n")
            paths.append(path)
        return paths

    def load(self, key: str) -> List[MeasurementRecord]:
        """All records appended under `key`, in append order (corrupt
        lines are skipped, never trusted)."""
        path = self.path_for(key)
        if not path.exists():
            return []
        out: List[MeasurementRecord] = []
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                out.append(MeasurementRecord.from_json(json.loads(line)))
            except (ValueError, KeyError, TypeError):
                continue
        return out

    def load_all(self) -> List[MeasurementRecord]:
        """Every record in the store, across all keys."""
        out: List[MeasurementRecord] = []
        for key in self.keys():
            out.extend(self.load(key))
        return out

    def keys(self) -> List[str]:
        if not self.root.is_dir():
            return []
        return sorted(p.stem for p in self.root.glob("*.jsonl"))

    def count(self, key: str) -> int:
        return len(self.load(key))
