"""Predictor calibration from accumulated measurement records.

The port's copy of the reference's calibrator, float for float.  The
planner's latency predictors model a *phone*; execution happens on
whatever host runs the plan (on the port, an H100 per-node walk).  A
`Calibrator` fits per-(op-kind, mode) **affine corrections in log space**

    log(wall_us)  ~=  a * log(pred_us) + b

from the records a `MeasurementStore` accumulated, and applies them to any
latency predictor **without retraining** (`wrap` returns a
`CalibratedPredictor` with the same `predict` contract).

Per group it scores three candidates, identity (a=1, b=0), the L1-optimal
log-shift (a=1, b=median of the log-residuals) and a least-squares affine
fit (only with >= 3 spread-out points), and keeps whichever minimizes the
summed |log wall - log cal| on the fitted records, so calibration never
increases the fidelity error on the records it was fit from.

A calibrator is JSON-persistable (`save`/`load`) and content-addressed:
`version` digests the fitted coefficients, and the cached planners fold it
into plan provenance (`PlanProvenance.calibration`), so a refit calibrator
invalidates dependent plans instead of aliasing them.  The same records
give the reference's `to_json()` and `version`, byte for byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.types import Op
from repro_torch.kernels.registry import op_kind
from repro_torch.measure.record import MeasurementRecord, usable_for_fidelity

CALIBRATION_SCHEMA_VERSION = 1

#: aggregate pseudo-mode: the per-kind fit over records of every mode
#: (what `CalibratedPredictor` applies when the mode is unknown at
#: predict time, i.e. during planning)
MODE_ANY = "*"


@dataclasses.dataclass(frozen=True)
class AffineCorrection:
    """log(cal_us) = a * log(pred_us) + b, fit on n records."""

    a: float
    b: float
    n: int

    def apply_us(self, pred_us: np.ndarray) -> np.ndarray:
        p = np.asarray(pred_us, dtype=float)
        safe = np.maximum(p, 1e-9)
        out = np.exp(self.a * np.log(safe) + self.b)
        # zero predictions stay zero: the partitioner's zero-channel
        # candidates and pool units carry no latency to correct
        return np.where(p > 0.0, out, 0.0)


#: minimum spread of the log-predictions (≈ a 1.65x ratio between the
#: cheapest and dearest fitted op) before the affine candidate is allowed:
#: on a tighter cluster the slope is unidentifiable — least-squares can
#: beat the shift *on the fitted records* with an extreme slope that then
#: extrapolates catastrophically to the planner's unseen candidate splits
MIN_AFFINE_SPREAD = 0.5


def _fit_group(logp: np.ndarray, logw: np.ndarray) -> AffineCorrection:
    """Best of {identity, L1-optimal shift, least-squares affine} by summed
    absolute log-residual — never worse than no correction."""
    cands = [(1.0, 0.0), (1.0, float(np.median(logw - logp)))]
    if len(logp) >= 3 and float(np.ptp(logp)) > MIN_AFFINE_SPREAD:
        A = np.vstack([logp, np.ones_like(logp)]).T
        coef, *_ = np.linalg.lstsq(A, logw, rcond=None)
        cands.append((float(coef[0]), float(coef[1])))
    a, b = min(cands,
               key=lambda ab: float(np.sum(np.abs(logw - (ab[0] * logp
                                                          + ab[1])))))
    return AffineCorrection(a=a, b=b, n=len(logp))


def fidelity_error(records: Iterable[MeasurementRecord],
                   calibrator: Optional["Calibrator"] = None) -> float:
    """Σ |log(wall/pred)| over usable records — the executed-vs-predicted
    fidelity error the acceptance metric tracks.  With a calibrator, the
    predictions are corrected first."""
    err = 0.0
    for r in records:
        if not usable_for_fidelity(r):
            continue
        pred = r.pred_us
        if calibrator is not None:
            pred = float(calibrator.correct_us(r.unit, r.mode, pred))
        if pred <= 0.0:
            continue
        err += abs(float(np.log(r.wall_us / pred)))
    return err


class Calibrator:
    """Per-(op-kind, mode) affine latency corrections, fit from records."""

    def __init__(self,
                 corrections: Dict[Tuple[str, str], AffineCorrection],
                 n_records: int = 0):
        self.corrections = dict(corrections)
        self.n_records = n_records

    # ----------------------------------------------------------- fitting
    @staticmethod
    def fit(records: Iterable[MeasurementRecord]) -> "Calibrator":
        """Fit per-(kind, mode) corrections plus a per-kind aggregate
        (mode `*`) from every usable record.

        The aggregate is what `CalibratedPredictor` applies to *per-
        backend* predictions at planning time, so it is fit only on
        records whose (pred, wall) pair describes an unsplit full-op
        execution (`exclusive`, `simulated`).  Co-executed records are
        unit totals — max-of-shards + sync overhead + deferred gather —
        and pairing them with per-shard predictions would encode that
        overhead into every candidate split; they still get their own
        (kind, "coexec") correction for fidelity accounting.
        """
        groups: Dict[Tuple[str, str], list] = {}
        usable = 0
        for r in records:
            if not usable_for_fidelity(r):
                continue
            usable += 1
            pair = (float(np.log(r.pred_us)), float(np.log(r.wall_us)))
            groups.setdefault((r.unit, r.mode), []).append(pair)
            if r.mode != "coexec":
                groups.setdefault((r.unit, MODE_ANY), []).append(pair)
        if usable == 0:
            raise ValueError("cannot fit a Calibrator from zero usable "
                             "records (need wall_us > 0 and pred_us > 0)")
        corrections = {}
        for key, pairs in groups.items():
            arr = np.asarray(pairs, dtype=float)
            corrections[key] = _fit_group(arr[:, 0], arr[:, 1])
        return Calibrator(corrections, n_records=usable)

    # ---------------------------------------------------------- applying
    def correction_for(self, kind: str, mode: str
                       ) -> Optional[AffineCorrection]:
        """The (kind, mode) correction, falling back to the per-kind
        aggregate; None when the kind was never measured."""
        return (self.corrections.get((kind, mode))
                or self.corrections.get((kind, MODE_ANY)))

    def correct_us(self, kind: str, mode: str, pred_us) -> np.ndarray:
        corr = self.correction_for(kind, mode)
        if corr is None:
            return np.asarray(pred_us, dtype=float)
        return corr.apply_us(pred_us)

    def fidelity_error(self, records: Iterable[MeasurementRecord]) -> float:
        """Calibrated fidelity error of `records` (see `fidelity_error`)."""
        return fidelity_error(records, self)

    def compose(self, inner: Optional["Calibrator"]) -> "Calibrator":
        """`self ∘ inner`: the calibrator equivalent to applying `inner`
        first, then `self` — affine-in-log corrections compose to affine.

        This is what *re*-calibration needs: records measured under a
        plan that already embeds `inner` carry `pred_us = inner(raw)`, so
        a calibrator fit from them maps inner-corrected predictions to
        walls.  Applying that fit to the raw predictors (which is what
        `wrap`/replanning does) silently drops `inner`; composing first
        yields corrections valid on raw predictions.  `inner=None` is the
        identity (a first calibration)."""
        if inner is None:
            return self
        out: Dict[Tuple[str, str], AffineCorrection] = {}
        for key in set(self.corrections) | set(inner.corrections):
            o = self.corrections.get(key, AffineCorrection(1.0, 0.0, 0))
            i = inner.corrections.get(key, AffineCorrection(1.0, 0.0, 0))
            out[key] = AffineCorrection(a=o.a * i.a, b=o.a * i.b + o.b,
                                        n=o.n or i.n)
        return Calibrator(out, n_records=self.n_records)

    def wrap(self, predictor) -> "CalibratedPredictor":
        """Wrap any latency predictor (LatencyPredictor or MuxPredictor)
        with these corrections — no retraining.  Wrapping an already
        calibrated predictor re-wraps the inner one (corrections never
        stack)."""
        if isinstance(predictor, CalibratedPredictor):
            predictor = predictor.inner
        return CalibratedPredictor(inner=predictor, calibration=self)

    # ------------------------------------------------------------ codecs
    @property
    def version(self) -> str:
        """Content digest of the fitted coefficients — what plan-cache
        provenance records (`PlanProvenance.calibration`)."""
        blob = json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.blake2b(blob.encode(), digest_size=12).hexdigest()

    def to_json(self) -> Dict[str, object]:
        return {"schema_version": CALIBRATION_SCHEMA_VERSION,
                "n_records": self.n_records,
                "corrections": [
                    {"unit": k[0], "mode": k[1], "a": c.a, "b": c.b,
                     "n": c.n}
                    for k, c in sorted(self.corrections.items())]}

    @staticmethod
    def from_json(d: Dict[str, object]) -> "Calibrator":
        if d.get("schema_version") != CALIBRATION_SCHEMA_VERSION:
            raise ValueError(f"unsupported calibration schema "
                             f"{d.get('schema_version')!r}")
        corrections = {
            (e["unit"], e["mode"]): AffineCorrection(a=e["a"], b=e["b"],
                                                     n=e["n"])
            for e in d["corrections"]}
        return Calibrator(corrections, n_records=int(d.get("n_records", 0)))

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1))
        return path

    @staticmethod
    def load(path: Union[str, Path]) -> "Calibrator":
        return Calibrator.from_json(json.loads(Path(path).read_text()))

    def summary(self) -> str:
        lines = [f"calibrator {self.version}: "
                 f"{len(self.corrections)} corrections from "
                 f"{self.n_records} records"]
        for (kind, mode), c in sorted(self.corrections.items()):
            lines.append(f"  {kind}/{mode}: log_wall ~= {c.a:.3f}*log_pred "
                         f"{c.b:+.3f}  (n={c.n})")
        return "\n".join(lines)


@dataclasses.dataclass
class CalibratedPredictor:
    """A latency predictor with measured-on-host corrections applied.

    Same `predict`/`device` contract as the wrapped predictor, so it drops
    into the batched planners unchanged; `runtime.plan.predictor_checksum`
    unwraps it (the calibration invalidates plans via the provenance
    `calibration` field instead).
    """

    inner: object                 # LatencyPredictor | MuxPredictor
    calibration: Calibrator

    @property
    def device(self) -> str:
        return self.inner.device

    def member(self, kind: str):
        """Per-kind member lookup, forwarded from the wrapped bundle —
        calibrating a `MuxPredictor` must not strip its ability to price
        attention/SSM typed-axis candidates (the planner gates those on
        `member(kind)`); returns None for plain per-kind predictors."""
        inner_member = getattr(self.inner, "member", None)
        if inner_member is None:
            return None
        return inner_member(kind)

    def predict(self, ops: Sequence[Op],
                tiles: Optional[Sequence] = None) -> np.ndarray:
        ops = list(ops)
        out = np.asarray(self.inner.predict(ops, tiles)
                         if tiles is not None else self.inner.predict(ops),
                         dtype=float).copy()
        kinds = np.array([op_kind(op) for op in ops])
        for kind in np.unique(kinds):
            sel = kinds == kind
            # the mode is unknown at predict time (planning scores every
            # candidate split); apply the per-kind aggregate fit
            out[sel] = self.calibration.correct_us(str(kind), MODE_ANY,
                                                   out[sel])
        return out
