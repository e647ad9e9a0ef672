"""Training of latency predictors (paper Sections 3.2, 5.2).

A `LatencyPredictor` maps operations to predicted latency (microseconds) for
one (device, backend) pair.  GPU white-box predictors are split per kernel
implementation and fed dispatch-augmented features; black-box predictors see
only the operation configuration (the ablation baseline).

Targets are log-latencies: squared loss on logs optimizes relative error,
which is what MAPE (Table 1) scores.

The port's copy of `repro.core.predictor.train`, tile-aware predictors
included (`tiles=True` appends an op's resolved TPU tile config, the
reference's features, so a tuned plan re-prices the same in both
packages).  A saved predictor is a pickle of the port's classes; `LatencyPredictor.load`
unpickles through `_PortUnpickler`, which resolves only the few globals
such a pickle names (the port's predictor classes and numpy's array
reconstructors), so a file that names anything else, the reference's
predictor cache among them, fails to load instead of importing or calling
it.
"""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.predictor.features import (blackbox_features, kernel_of,
                                                 tile_features,
                                                 whitebox_features)
from repro_torch.core.predictor.gbdt import GBDTParams, GBDTRegressor
from repro_torch.core.simulator.measure import measure_latency_us
from repro_torch.core.types import Op


#: every global a saved predictor names (numpy 2 and numpy 1 spellings of
#: the array reconstructors); exact pairs, so no dotted name resolves
_PICKLE_GLOBALS = frozenset({
    ("repro_torch.core.predictor.train", "LatencyPredictor"),
    ("repro_torch.core.predictor.gbdt", "GBDTRegressor"),
    ("repro_torch.core.predictor.gbdt", "GBDTParams"),
    ("repro_torch.core.predictor.gbdt", "_Tree"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
})


class _PortUnpickler(pickle.Unpickler):
    """Unpickles the port's predictors and nothing else: any global outside
    `_PICKLE_GLOBALS` raises `pickle.UnpicklingError` before its module is
    imported."""

    def find_class(self, module: str, name: str):
        if (module, name) in _PICKLE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a saved predictor may not name "
                                     f"{module}.{name}")


@dataclasses.dataclass
class LatencyPredictor:
    device: str
    backend: str                    # 'gpu' | 'cpu1' | 'cpu2' | 'cpu3'
    whitebox: bool
    models: Dict[str, GBDTRegressor]   # kernel -> model ('*' if not split)
    #: when True the feature vectors carry the resolved TPU tile config
    #: (see features.tile_features), so `predict(ops, tiles=...)` re-prices
    #: tuned decisions; False keeps the tile-blind vectors and checksums
    #: (read via getattr: predictors pickled before this field existed
    #: unpickle without it)
    tiles: bool = False

    @property
    def tile_aware(self) -> bool:
        return bool(getattr(self, "tiles", False))

    def _featurize(self, ops: Sequence[Op], tiles) -> np.ndarray:
        feats = (whitebox_features(ops, self.device)
                 if self.whitebox and self.backend == "gpu"
                 else blackbox_features(ops))
        if self.tile_aware:
            feats = np.hstack([feats, tile_features(ops, tiles)])
        return feats

    def predict(self, ops: Sequence[Op],
                tiles: Optional[Sequence] = None) -> np.ndarray:
        ops = list(ops)
        out = np.empty(len(ops))
        feats = self._featurize(ops, tiles)
        if not self.whitebox or self.backend != "gpu":
            model = self.models["*"]
            out[:] = np.exp(model.predict(feats))
            return out
        # white-box GPU: route each op to its kernel's model
        kernels = np.array([kernel_of(op, self.device) for op in ops])
        for kern in np.unique(kernels):
            sel = kernels == kern
            model = self.models.get(kern) or self.models["*"]
            out[sel] = np.exp(model.predict(feats[sel]))
        return out

    def save(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: Path) -> "LatencyPredictor":
        with open(path, "rb") as f:
            pred = _PortUnpickler(f).load()
        if not isinstance(pred, LatencyPredictor):
            raise pickle.UnpicklingError(f"{path} holds a "
                                         f"{type(pred).__name__}, not a "
                                         f"LatencyPredictor")
        return pred


def measure_ops(ops: Sequence[Op], device: str, backend: str,
                seed: int = 0) -> np.ndarray:
    return np.array([measure_latency_us(op, device, backend, seed=seed)
                     for op in ops])


def train_predictor(ops: Sequence[Op], device: str, backend: str, *,
                    whitebox: bool = True,
                    params: Optional[GBDTParams] = None,
                    y_us: Optional[np.ndarray] = None,
                    tiles: bool = False,
                    tile_list: Optional[Sequence] = None,
                    hpo_trials: int = 0, seed: int = 0) -> LatencyPredictor:
    """Fit a predictor on measured latencies of `ops`: the simulator's,
    or `y_us` (e.g. `dataset.training_from_records` of executed runs).

    hpo_trials > 0 runs the reference's random hyperparameter search
    (`GBDTParams.random`) with a held-out validation split (20 %), as in
    the paper's Section 5.2; `params` overrides it.  `tiles=True` appends
    each op's resolved TPU tile config to the feature vector
    (`tile_list[i]` when given, else the default blocking): a tile-aware
    predictor that re-prices tuned decisions; the default keeps feature
    vectors, and the checksum cached plans key on, tile-blind.
    """
    ops = list(ops)
    y = measure_ops(ops, device, backend, seed=seed) if y_us is None \
        else np.asarray(y_us)
    logy = np.log(np.maximum(y, 1e-3))

    gpu_wb = whitebox and backend == "gpu"
    X = whitebox_features(ops, device) if gpu_wb else blackbox_features(ops)
    if tiles:
        X = np.hstack([X, tile_features(ops, tile_list)])

    def fit_group(Xg, yg, prm):
        return GBDTRegressor(prm, seed=seed).fit(Xg, yg)

    def choose_params(Xg, yg) -> GBDTParams:
        if params is not None:
            return params
        if hpo_trials <= 0:
            return GBDTParams()
        rng = np.random.default_rng(seed + 17)
        n = len(yg)
        idx = rng.permutation(n)
        cut = max(1, int(0.8 * n))
        tr, va = idx[:cut], idx[cut:]
        best, best_err = GBDTParams(), np.inf
        for _ in range(hpo_trials):
            cand = GBDTParams.random(rng)
            m = GBDTRegressor(cand, seed=seed).fit(Xg[tr], yg[tr])
            err = float(np.mean(np.abs(np.exp(m.predict(Xg[va]))
                                       - np.exp(yg[va]))
                                / np.exp(yg[va])))
            if err < best_err:
                best, best_err = cand, err
        return best

    models: Dict[str, GBDTRegressor] = {}
    if gpu_wb:
        kernels = np.array([kernel_of(op, device) for op in ops])
        for kern in np.unique(kernels):
            sel = kernels == kern
            if sel.sum() < 30:       # too few samples: fall through to '*'
                continue
            prm = choose_params(X[sel], logy[sel])
            models[kern] = fit_group(X[sel], logy[sel], prm)
        # global fallback model over all samples
        prm = choose_params(X, logy)
        models["*"] = fit_group(X, logy, prm)
    else:
        prm = choose_params(X, logy)
        models["*"] = fit_group(X, logy, prm)

    return LatencyPredictor(device=device, backend=backend,
                            whitebox=gpu_wb, models=models, tiles=tiles)


def mape(pred_us: np.ndarray, true_us: np.ndarray) -> float:
    true_us = np.asarray(true_us)
    return float(np.mean(np.abs(pred_us - true_us) / np.maximum(true_us,
                                                                1e-9)))


@dataclasses.dataclass
class MuxPredictor:
    """Routes each op kind to its own per-kind predictor; the end-to-end
    planner spans every kind in a graph.  The decode-kind members default
    to None so conv/linear-only predictor bundles (and their cached
    pickles/checksums) are unchanged from before attention/SSM became
    plannable."""

    linear: LatencyPredictor
    conv: LatencyPredictor
    attention: Optional[LatencyPredictor] = None
    ssm: Optional[LatencyPredictor] = None

    @property
    def device(self) -> str:
        return self.linear.device

    def member(self, kind: str) -> Optional[LatencyPredictor]:
        return getattr(self, "attention" if kind == "attention" else
                       "ssm" if kind == "ssm" else kind, None)

    def predict(self, ops: Sequence[Op],
                tiles: Optional[Sequence] = None) -> np.ndarray:
        from repro_torch.kernels.registry import op_kind
        ops = list(ops)
        out = np.empty(len(ops))
        kinds = [op_kind(o) for o in ops]
        for kind in sorted(set(kinds)):
            idx = [i for i, k in enumerate(kinds) if k == kind]
            member = self.member(kind)
            if member is None:
                raise ValueError(
                    f"MuxPredictor has no {kind!r} member; train with "
                    f"kinds including {kind!r}")
            out[idx] = member.predict(
                [ops[i] for i in idx],
                None if tiles is None else [tiles[i] for i in idx])
        return out
