"""Feature construction for the latency predictors.

Two regimes, mirroring the paper's ablation (Tab. 4):

  * **black-box** — operation configuration only (shapes, FLOPs, bytes):
    what prior work [9,13,15,22] uses; captures trends, misses spikes.
  * **white-box (augmented)** — adds kernel *dispatch* features recovered
    from the delegate heuristics (Section 3.2): workgroup shape/size/count,
    grid dims, wave count, wave quantization waste, occupancy, padded FLOPs.
    White-box predictors are additionally trained *per kernel
    implementation* (linear / conv_generic / conv_constant / winograd).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.simulator.devices import DEVICES
from repro_torch.core.simulator.gpu_model import dispatch_for
from repro_torch.core.types import Op
from repro_torch.kernels import registry

BLACKBOX_LINEAR = ["L", "C_in", "C_out", "log_flops", "log_weight_bytes"]
BLACKBOX_CONV = ["H_in", "W_in", "C_in", "C_out", "K", "S",
                 "log_flops", "log_weight_bytes"]
# the trailing mode index is what lets one predictor price both kernel
# modes (streaming/materialized, chunked/recurrent) of a decode kind
BLACKBOX_ATTENTION = ["H", "S", "KV", "hd", "window",
                      "log_flops", "log_weight_bytes", "mode_index"]
BLACKBOX_SSM = ["T", "H", "hd", "N",
                "log_flops", "log_weight_bytes", "mode_index"]
_BLACKBOX_BY_KIND = {"linear": BLACKBOX_LINEAR, "conv": BLACKBOX_CONV,
                     "attention": BLACKBOX_ATTENTION, "ssm": BLACKBOX_SSM}
DISPATCH_FEATURES = ["wg_x", "wg_y", "wg_size", "grid_x", "grid_y",
                     "wg_count", "waves", "wave_quant", "occupancy",
                     "log_padded_flops"]


def tile_feature_names(kind: str) -> List[str]:
    """Per-kind kernel tile-config feature names ("tile_bm", ...), in the
    registry `TileSpec` parameter order (the reference's TPU tiles)."""
    return [f"tile_{n}" for n in registry.tile_spec(kind).names()]


def tile_features(ops: Sequence[Op], tiles=None) -> np.ndarray:
    """Resolved TPU tile-config values per op, one row per op, as the
    reference computes them.

    `tiles[i]` is op i's `TileConfig` (a decision's `tile` key) or None;
    None (and a missing list) resolves to the kind's clamped default, so a
    tile-aware predictor prices a reference-tuned plan's decisions exactly
    as the reference does.  Only meaningful for same-kind batches —
    feature widths differ across kinds.
    """
    if tiles is None:
        tiles = [None] * len(ops)
    rows = []
    for op, tile in zip(ops, tiles):
        resolved = registry.resolve_tile(op, tile)
        rows.append([float(v) for _, v in resolved.values])
    return np.array(rows, dtype=np.float64)


def _base_features(op: Op) -> List[float]:
    # one dispatch table for planner and executor: the registry owns the
    # per-kind base feature extractors
    return registry.entry_for(op).base_features(op)


def blackbox_features(ops: Sequence[Op]) -> np.ndarray:
    return np.array([_base_features(op) for op in ops], dtype=np.float64)


def _dispatch_features(op: Op, device: str) -> List[float]:
    from repro_torch.core.simulator.gpu_model import _OCCUPANCY_THREADS_PER_CU
    dev = DEVICES[device]
    d = dispatch_for(op, dev)
    slots = dev.gpu_compute_units * max(1, int(512 // max(1, d.wg_size)))
    waves = -(-d.wg_count // slots)
    quant = waves * slots / max(1, d.wg_count)
    occ = min(1.0, d.total_threads /
              (_OCCUPANCY_THREADS_PER_CU * dev.gpu_compute_units))
    return [d.wg_x, d.wg_y, d.wg_size, d.grid_x, d.grid_y, d.wg_count,
            waves, quant, occ, np.log(max(d.padded_flops, 1))]


def whitebox_features(ops: Sequence[Op], device: str) -> np.ndarray:
    return np.array(
        [_base_features(op) + _dispatch_features(op, device) for op in ops],
        dtype=np.float64)


def kernel_of(op: Op, device: str) -> str:
    return dispatch_for(op, DEVICES[device]).kernel


def feature_names(ops_kind: str, whitebox: bool,
                  tiles: bool = False) -> List[str]:
    base = _BLACKBOX_BY_KIND.get(ops_kind, BLACKBOX_CONV)
    names = base + DISPATCH_FEATURES if whitebox else list(base)
    return names + tile_feature_names(ops_kind) if tiles else names
