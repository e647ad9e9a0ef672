"""From-scratch histogram gradient-boosted decision trees (NumPy).

The paper trains LightGBM GBDTs (Section 5.2); LightGBM is not a
dependency, so this is a compact reimplementation of the same algorithm
class: quantile-binned features, level-wise regression trees with
L2-regularized gain, squared loss on log-latency (so optimizing relative
error, which is what MAPE measures), shrinkage, and row subsampling.

Vectorized histogram construction keeps training fast enough to fit the
paper's full predictor matrix (4 devices x {GPU, 1-3 CPU threads} x
{linear, conv} x per-kernel splits) on one CPU core.

The port's copy of `repro.core.predictor.gbdt`: the same `np.quantile`
binning, the same seeded row subsampling and the same float operations in
the same order, so a fit here gives the reference's trees array for array
(`runtime.plan.predictor_checksum` hashes them).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

_MAX_BINS = 64


@dataclasses.dataclass
class GBDTParams:
    n_estimators: int = 300
    learning_rate: float = 0.08
    max_depth: int = 7
    min_child_samples: int = 4
    reg_lambda: float = 1.0
    subsample: float = 0.9
    max_bins: int = _MAX_BINS

    @staticmethod
    def random(rng: np.random.Generator) -> "GBDTParams":
        """Optuna-style random draw over the paper's hyperparameter ranges
        (the reference's draw order, so one seed gives the same params)."""
        return GBDTParams(
            n_estimators=int(rng.integers(100, 500)),
            learning_rate=float(10 ** rng.uniform(-2, np.log10(0.2))),
            max_depth=int(rng.integers(5, 11)),
            min_child_samples=int(rng.integers(2, 16)),
            reg_lambda=float(10 ** rng.uniform(-4, 0)),
            subsample=float(rng.uniform(0.5, 1.0)),
        )


class _Tree:
    """One level-wise regression tree over pre-binned features."""

    __slots__ = ("feature", "threshold_bin", "left", "right", "value",
                 "n_nodes")

    def __init__(self, n_nodes: int):
        self.feature = np.full(n_nodes, -1, dtype=np.int32)
        self.threshold_bin = np.zeros(n_nodes, dtype=np.int32)
        self.left = np.full(n_nodes, -1, dtype=np.int32)
        self.right = np.full(n_nodes, -1, dtype=np.int32)
        self.value = np.zeros(n_nodes, dtype=np.float64)
        self.n_nodes = n_nodes

    def predict_binned(self, Xb: np.ndarray) -> np.ndarray:
        node = np.zeros(Xb.shape[0], dtype=np.int32)
        # depth is bounded, iterate until all rows sit on leaves
        for _ in range(64):
            feat = self.feature[node]
            active = feat >= 0
            if not active.any():
                break
            rows = np.nonzero(active)[0]
            f = feat[rows]
            go_left = Xb[rows, f] <= self.threshold_bin[node[rows]]
            node[rows] = np.where(go_left, self.left[node[rows]],
                                  self.right[node[rows]])
        return self.value[node]


class GBDTRegressor:
    """predict() operates on raw feature matrices; fit() bins them first."""

    def __init__(self, params: Optional[GBDTParams] = None, seed: int = 0):
        self.params = params or GBDTParams()
        self.seed = seed
        self.trees: List[_Tree] = []
        self.bin_edges_: Optional[List[np.ndarray]] = None
        self.base_: float = 0.0
        self.feature_gain_: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ fit
    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, n_feat = X.shape
        p = self.params
        rng = np.random.default_rng(self.seed)

        # --- quantile binning ---
        self.bin_edges_ = []
        Xb = np.empty((n, n_feat), dtype=np.int32)
        for j in range(n_feat):
            qs = np.quantile(X[:, j], np.linspace(0, 1, p.max_bins + 1)[1:-1])
            edges = np.unique(qs)
            self.bin_edges_.append(edges)
            Xb[:, j] = np.searchsorted(edges, X[:, j], side="right")
        n_bins = p.max_bins

        self.base_ = float(y.mean())
        pred = np.full(n, self.base_)
        self.trees = []
        self.feature_gain_ = np.zeros(n_feat)

        for _ in range(p.n_estimators):
            if p.subsample < 1.0:
                mask = rng.random(n) < p.subsample
                if mask.sum() < 2 * p.min_child_samples:
                    mask[:] = True
            else:
                mask = np.ones(n, dtype=bool)
            grad = pred - y          # d/dpred of 0.5*(pred-y)^2
            tree = self._fit_tree(Xb[mask], grad[mask], n_bins)
            self.trees.append(tree)
            pred += p.learning_rate * tree.predict_binned(Xb)
        return self

    def _fit_tree(self, Xb: np.ndarray, grad: np.ndarray,
                  n_bins: int) -> _Tree:
        p = self.params
        n, n_feat = Xb.shape
        max_nodes = 2 ** (p.max_depth + 1)
        tree = _Tree(max_nodes)
        node_of = np.zeros(n, dtype=np.int32)
        # frontier: list of node ids at current depth
        frontier = [0]
        next_free = 1
        lam = p.reg_lambda

        for depth in range(p.max_depth):
            if not frontier:
                break
            n_nodes_level = max(frontier) + 1
            # histograms: grad sum and count per (node, feature, bin)
            flat = node_of[:, None] * (n_feat * n_bins) \
                + np.arange(n_feat)[None, :] * n_bins + Xb
            size = n_nodes_level * n_feat * n_bins
            gh = np.bincount(flat.ravel(), weights=np.repeat(grad, n_feat),
                             minlength=size).reshape(n_nodes_level, n_feat,
                                                     n_bins)
            ch = np.bincount(flat.ravel(), minlength=size).reshape(
                n_nodes_level, n_feat, n_bins).astype(np.float64)

            gl = np.cumsum(gh, axis=2)
            cl = np.cumsum(ch, axis=2)
            gt = gl[:, :, -1:]
            ct = cl[:, :, -1:]
            gr = gt - gl
            cr = ct - cl
            valid = (cl >= p.min_child_samples) & (cr >= p.min_child_samples)
            gain = (gl ** 2 / (cl + lam) + gr ** 2 / (cr + lam)
                    - gt ** 2 / (ct + lam))
            gain = np.where(valid, gain, -np.inf)

            new_frontier = []
            for node in frontier:
                g = gain[node]
                j, b = np.unravel_index(np.argmax(g), g.shape)
                best = g[j, b]
                ctot = ct[node, 0, 0]
                gtot = gt[node, 0, 0]
                if not np.isfinite(best) or best <= 1e-12 or ctot == 0:
                    tree.value[node] = -gtot / (ctot + lam)
                    continue
                li, ri = next_free, next_free + 1
                next_free += 2
                tree.feature[node] = j
                tree.threshold_bin[node] = b
                tree.left[node], tree.right[node] = li, ri
                self.feature_gain_[j] += float(best)
                new_frontier += [li, ri]

            if not new_frontier:
                break
            # route samples to children
            feat = tree.feature[node_of]
            splittable = feat >= 0
            rows = np.nonzero(splittable)[0]
            go_left = Xb[rows, feat[rows]] <= tree.threshold_bin[node_of[rows]]
            node_of[rows] = np.where(go_left, tree.left[node_of[rows]],
                                     tree.right[node_of[rows]])
            frontier = new_frontier

        # finalize any remaining frontier leaves
        for node in frontier:
            sel = node_of == node
            c = float(sel.sum())
            if c > 0:
                tree.value[node] = -float(grad[sel].sum()) / (c + lam)
        return tree

    # -------------------------------------------------------------- predict
    def _bin(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        Xb = np.empty(X.shape, dtype=np.int32)
        for j, edges in enumerate(self.bin_edges_):
            Xb[:, j] = np.searchsorted(edges, X[:, j], side="right")
        return Xb

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xb = self._bin(X)
        out = np.full(Xb.shape[0], self.base_)
        lr = self.params.learning_rate
        for t in self.trees:
            out += lr * t.predict_binned(Xb)
        return out
