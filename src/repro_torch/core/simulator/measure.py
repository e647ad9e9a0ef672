"""Measurement interface over the analytic device models.

`measure(...)` is the only way the rest of the system observes "hardware":
it adds reproducible log-normal measurement noise (thermal/scheduling jitter
survives even the paper's cooling-fan protocol, Section 5.1) so that the
trained predictors never see the analytic oracle exactly — the Table 1 MAPE
numbers are only meaningful against noisy observations.

The port's copy of `repro.core.simulator.measure`, float for float: the
noise stream of an op is seeded by `_stable_seed`, a digest of the op's
`repr`, so both packages observe the same jitter and train the same trees.
`measure_records(...)` emits the same observations as measurement records
(wall = noisy measurement, pred = noise-free oracle), so simulator
measurements, executed plan runs and predictor training sets all flow
through one record type.
"""
from __future__ import annotations

import hashlib
from typing import TYPE_CHECKING, List, Sequence

import numpy as np

from repro_torch.core.simulator.cpu_model import cpu_latency_us
from repro_torch.core.simulator.decode_model import (attn_cpu_latency_us,
                                                     attn_gpu_latency_us,
                                                     ssm_cpu_latency_us,
                                                     ssm_gpu_latency_us)
from repro_torch.core.simulator.devices import DEVICES
from repro_torch.core.simulator.gpu_model import gpu_latency_us
from repro_torch.core.types import AttnOp, Op, SSMOp

if TYPE_CHECKING:
    from repro_torch.measure.record import MeasurementRecord

_NOISE_SIGMA = 0.030


def _stable_seed(*parts) -> int:
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def true_latency_us(op: Op, device: str, backend: str) -> float:
    """Noise-free latency (the simulator oracle). backend: 'gpu' | 'cpuN'."""
    dev = DEVICES[device]
    if isinstance(op, (AttnOp, SSMOp)):
        if backend == "gpu":
            return (attn_gpu_latency_us(op, dev) if isinstance(op, AttnOp)
                    else ssm_gpu_latency_us(op, dev))
        if backend.startswith("cpu"):
            threads = int(backend[3:] or 1)
            return (attn_cpu_latency_us(op, dev, threads)
                    if isinstance(op, AttnOp)
                    else ssm_cpu_latency_us(op, dev, threads))
        raise ValueError(f"unknown backend {backend!r}")
    if op.C_out == 0:
        return 0.0
    if backend == "gpu":
        return gpu_latency_us(op, dev)
    if backend.startswith("cpu"):
        return cpu_latency_us(op, dev, int(backend[3:] or 1))
    raise ValueError(f"unknown backend {backend!r}")


def measure_latency_us(op: Op, device: str, backend: str,
                       repeats: int = 5, seed: int = 0) -> float:
    """Noisy measurement: median of `repeats` jittered observations."""
    return float(measure_latency_us_batch([op], device, backend,
                                          repeats=repeats, seed=seed)[0])


def _measure_batch_with_base(ops: Sequence[Op], device: str, backend: str,
                             repeats: int, seed: int
                             ) -> "tuple[np.ndarray, np.ndarray]":
    """(noisy medians, noise-free oracle) — the oracle is evaluated once
    and shared by both outputs."""
    base = np.array([true_latency_us(op, device, backend) for op in ops])
    out = np.zeros(len(ops))
    nz = np.nonzero(base)[0]
    if nz.size == 0:
        return out, base
    noise = np.empty((nz.size, repeats))
    for row, i in enumerate(nz):
        rng = np.random.default_rng(_stable_seed(device, backend, ops[i],
                                                 seed))
        noise[row] = rng.normal(0.0, _NOISE_SIGMA, size=repeats)
    out[nz] = np.median(base[nz, None] * np.exp(noise), axis=1)
    return out, base


def measure_latency_us_batch(ops: Sequence[Op], device: str, backend: str,
                             repeats: int = 5, seed: int = 0) -> np.ndarray:
    """Batched measurement: one call for a whole candidate grid.

    Bit-identical to calling `measure_latency_us` per op — each op keeps its
    own stable noise stream (seeded by the op itself, so the same op measured
    alone or inside any batch observes the same jitter) while the noise
    application and median reduction are vectorized across the batch.
    """
    return _measure_batch_with_base(list(ops), device, backend, repeats,
                                    seed)[0]


def measure_records(ops: Sequence[Op], device: str, backend: str,
                    repeats: int = 5, seed: int = 0
                    ) -> List["MeasurementRecord"]:
    """Batched measurement as records: one `MeasurementRecord` per op,
    `wall_us` = the noisy observation (bit-identical to
    `measure_latency_us_batch`), `pred_us` = the noise-free oracle."""
    from repro_torch.measure.record import record_for_op
    ops = list(ops)
    walls, oracle = _measure_batch_with_base(ops, device, backend, repeats,
                                             seed)
    return [record_for_op(op, index=i, wall_us=float(walls[i]),
                          pred_us=float(oracle[i]),
                          device=device, backend=backend)
            for i, op in enumerate(ops)]
