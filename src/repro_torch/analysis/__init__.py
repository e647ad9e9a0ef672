"""Static analysis over plan artifacts (the port's copy of the reference's
`repro.analysis`).

`analysis.verify` proves co-execution invariants over serialized plans
without executing anything.  It backs `python -m repro_torch verify` and
the strict-load paths in `runtime.plan` and `api`.  The reference's
repo-contract linter and its cache-rejection log belong to the JAX
package's source tree and plan cache, and are not part of the port.
"""
from repro_torch.analysis.verify import (RULES, SEV_ERROR, SEV_INFO,
                                         SEV_WARNING, Diagnostic, PlanStats,
                                         VerificationError, errors,
                                         plan_stats, raise_on_error,
                                         verify_artifact, verify_path,
                                         verify_plan)

__all__ = [
    "RULES", "SEV_ERROR", "SEV_INFO", "SEV_WARNING",
    "Diagnostic", "PlanStats", "VerificationError",
    "errors", "plan_stats", "raise_on_error",
    "verify_artifact", "verify_path", "verify_plan",
]
