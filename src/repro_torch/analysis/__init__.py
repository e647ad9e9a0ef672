"""Static analysis over plan artifacts (the port's copy of the reference's
`repro.analysis`).

`analysis.verify` proves co-execution invariants over serialized plans
without executing anything.  It backs `python -m repro_torch verify` and
the strict-load paths in `runtime.plan`, `runtime.cache` and `api`.
`rejections` records which rule each plan-cache entry the cache refused
failed.  `analysis.lint` is the port's repo-contract linter (`python -m
repro_torch lint`), under the reference's rule ids.
"""
import logging
from typing import Dict, List, Tuple

from repro_torch.analysis.verify import (RULES, SEV_ERROR, SEV_INFO,
                                         SEV_WARNING, Diagnostic, PlanStats,
                                         VerificationError, errors,
                                         plan_stats, raise_on_error,
                                         verify_artifact, verify_path,
                                         verify_plan, verify_portfolio,
                                         verify_tune_entry)

__all__ = [
    "RULES", "SEV_ERROR", "SEV_INFO", "SEV_WARNING",
    "Diagnostic", "PlanStats", "VerificationError",
    "errors", "plan_stats", "raise_on_error",
    "verify_artifact", "verify_path", "verify_plan", "verify_portfolio",
    "verify_tune_entry",
    "RejectionLog", "rejections",
]

_log = logging.getLogger("repro_torch.analysis")


class RejectionLog:
    """Process-wide record of cache entries rejected by verification.

    Instead of degrading a corrupt or mismatched entry to a silent miss,
    `PlanCache` records which rule (or which provenance field) failed,
    warns once per digest, and lets the CLI print the counts
    (`python -m repro_torch plan -v`).
    """

    def __init__(self):
        self._seen: Dict[str, Tuple[str, str]] = {}   # digest -> (rule, why)
        self._counts: Dict[str, int] = {}             # rule -> rejections

    def record(self, digest: str, rule: str, detail: str = "") -> None:
        if digest in self._seen:
            return                         # warn once per digest
        self._seen[digest] = (rule, detail)
        self._counts[rule] = self._counts.get(rule, 0) + 1
        why = f": {detail}" if detail else ""
        _log.warning("cache entry %s rejected by %s%s", digest, rule, why)

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def total(self) -> int:
        return sum(self._counts.values())

    def entries(self) -> List[Tuple[str, str, str]]:
        return [(digest, rule, detail)
                for digest, (rule, detail) in sorted(self._seen.items())]

    def summary(self) -> str:
        if not self._counts:
            return "cache rejections: none"
        parts = ", ".join(f"{rule} x{n}"
                          for rule, n in sorted(self._counts.items()))
        return f"cache rejections: {self.total()} ({parts})"

    def clear(self) -> None:
        self._seen.clear()
        self._counts.clear()


#: process-wide singleton the plan cache reports into
rejections = RejectionLog()
