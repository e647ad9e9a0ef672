"""Measurement, calibration and adaptive replanning: the feedback loop.

The port's copy of the reference's `repro.measure`, less the drift
monitor (it has no caller outside serving).  One schema
(`MeasurementRecord`) for every timing: executed plan runs
(`runtime/executor`) and simulator measurements
(`core/simulator/measure.measure_records`).  An append-only
`MeasurementStore` (JSONL under `reports/measurements/`, keyed by the plan
cache's provenance digests) accumulates them; a `Calibrator` fits
per-(op-kind, mode) affine corrections and wraps any latency predictor
without retraining (`CalibratedPredictor`); `replan` re-runs the cached
planners under the corrections and diffs the plans (`PlanDiff`).  Facade
spellings: `CompiledNetwork.record() / recalibrate() / replan()` and
`python -m repro_torch calibrate`.

Exports resolve lazily (PEP 562); recording, fitting and replanning are
host-side bookkeeping (numpy), whatever device the records came from.
"""
import importlib

_EXPORTS = {
    "MEASUREMENT_SCHEMA_VERSION": "repro_torch.measure.record",
    "MeasurementRecord": "repro_torch.measure.record",
    "SOURCE_EXECUTOR": "repro_torch.measure.record",
    "SOURCE_FUSED": "repro_torch.measure.record",
    "SOURCE_SIMULATOR": "repro_torch.measure.record",
    "record_for_op": "repro_torch.measure.record",
    "usable_for_fidelity": "repro_torch.measure.record",
    "DEFAULT_STORE_DIR": "repro_torch.measure.store",
    "MeasurementStore": "repro_torch.measure.store",
    "AffineCorrection": "repro_torch.measure.calibrate",
    "CalibratedPredictor": "repro_torch.measure.calibrate",
    "Calibrator": "repro_torch.measure.calibrate",
    "fidelity_error": "repro_torch.measure.calibrate",
    "DecisionChange": "repro_torch.measure.replan",
    "PlanDiff": "repro_torch.measure.replan",
    "diff_plans": "repro_torch.measure.replan",
    "replan": "repro_torch.measure.replan",
    "score_decisions": "repro_torch.measure.replan",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
