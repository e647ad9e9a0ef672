"""White-box model of the TFLite GPU (OpenCL) delegate.

This module re-implements, in simplified analytic form, the two mechanisms
the paper identifies as the cause of discontinuous GPU latency (Section 3.1):

  1. *Heuristic workgroup choices* — the delegate picks a workgroup shape by
     divisibility heuristics; awkward output-channel counts fall back to tiny
     workgroups, inflating the workgroup count and the latency (Fig. 6a).
  2. *Kernel selection* — convolutions switch between `conv_constant`,
     `winograd` and `conv_generic` implementations based on the operation
     parameters, with distinct performance characteristics (Fig. 6b).

The latency model is wave-based: workgroups execute in waves across compute
units, so latency is a *step function* of the workgroup count — exactly the
quantization that black-box shape-only predictors cannot capture.

Everything here is deterministic given (device, op); the measurement noise
lives in measure.py.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.simulator.devices import DeviceSpec
from repro_torch.core.types import ConvOp, LinearOp, Op

# Kernel implementation identifiers (match the paper's Section 3.2 taxonomy).
KERNEL_LINEAR = "linear_generic"
KERNEL_CONV_GENERIC = "conv_generic"
KERNEL_CONV_CONSTANT = "conv_constant"
KERNEL_CONV_WINOGRAD = "winograd"

ALL_KERNELS = (
    KERNEL_LINEAR,
    KERNEL_CONV_GENERIC,
    KERNEL_CONV_CONSTANT,
    KERNEL_CONV_WINOGRAD,
)

# Candidate workgroup shapes (x: float4 output-channel slices, y: rows),
# ordered by preference, mirroring the delegate's divisor-based selection.
_LINEAR_WG_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (64, 2), (32, 4), (32, 2), (16, 4), (8, 4),
)
_LINEAR_WG_FALLBACK: Tuple[int, int] = (4, 4)

_CONV_WG_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (32, 4), (16, 8), (16, 4), (8, 8), (8, 4),
)
_CONV_WG_FALLBACK: Tuple[int, int] = (4, 4)

# Threads needed per compute unit for full latency hiding; below this the
# kernel is occupancy-bound (matters for skinny matrices, e.g. L=50).
_OCCUPANCY_THREADS_PER_CU = 2048.0
# Per-workgroup scheduling cost.
_WG_SCHED_US = 0.055
# Workgroups below this thread count underutilize the SIMD lanes.
_FULL_EFF_THREADS = 64.0


@dataclasses.dataclass(frozen=True)
class GpuDispatch:
    """Kernel dispatch information — the paper's augmentation features."""

    kernel: str
    wg_x: int                 # workgroup shape (channel-slices dimension)
    wg_y: int                 # workgroup shape (spatial/row dimension)
    grid_x: int               # number of workgroups along x
    grid_y: int               # number of workgroups along y
    total_threads: int
    padded_flops: float

    @property
    def wg_size(self) -> int:
        return self.wg_x * self.wg_y

    @property
    def wg_count(self) -> int:
        return self.grid_x * self.grid_y


def _pick_workgroup(out_slices: int, rows: int,
                    candidates: Tuple[Tuple[int, int], ...],
                    fallback: Tuple[int, int]) -> Tuple[int, int]:
    """Divisor-preference heuristic: the first candidate whose x dimension
    divides the output-slice count (with enough rows to fill y) wins; awkward
    channel counts fall through to a small, inefficient workgroup."""
    for wx, wy in candidates:
        if out_slices % wx == 0 and rows >= wy:
            return wx, wy
    # Secondary pass: accept <=12.5% padding along x.
    for wx, wy in candidates:
        if rows >= wy and (-out_slices) % wx <= wx // 8:
            return wx, wy
    return fallback


def select_conv_kernel(op: ConvOp, dev: DeviceSpec) -> str:
    """TFLite-style convolution kernel selection (Section 3.2)."""
    if (op.K == 3 and op.S == 1 and op.C_out >= 128
            and op.H_out * op.W_out >= 1024 and op.C_in >= 32):
        return KERNEL_CONV_WINOGRAD
    if op.weight_bytes <= dev.gpu_constant_mem_kb * 1024:
        return KERNEL_CONV_CONSTANT
    return KERNEL_CONV_GENERIC


def dispatch_for(op: Op, dev: DeviceSpec) -> GpuDispatch:
    """Compute the kernel choice + workgroup geometry for an operation."""
    if isinstance(op, LinearOp):
        out_slices = _ceil_div(op.C_out, 4)
        rows = op.L
        wx, wy = _pick_workgroup(out_slices, rows, _LINEAR_WG_CANDIDATES,
                                 _LINEAR_WG_FALLBACK)
        gx, gy = _ceil_div(out_slices, wx), _ceil_div(rows, wy)
        padded_flops = (gx * wx * 4) * (gy * wy) * op.C_in * 2.0
        return GpuDispatch(KERNEL_LINEAR, wx, wy, gx, gy,
                           out_slices * rows, padded_flops)

    kernel = select_conv_kernel(op, dev)
    out_slices = _ceil_div(op.C_out, 4)
    if kernel == KERNEL_CONV_WINOGRAD:
        # F(2x2, 3x3): one thread per 2x2 output tile per channel slice.
        rows = _ceil_div(op.H_out, 2) * _ceil_div(op.W_out, 2)
        reduction = 16 * op.C_in * 2.0          # 4x4 Hadamard-domain MACs
    else:
        rows = op.H_out * op.W_out
        reduction = op.K * op.K * op.C_in * 2.0
    wx, wy = _pick_workgroup(out_slices, rows, _CONV_WG_CANDIDATES,
                             _CONV_WG_FALLBACK)
    gx, gy = _ceil_div(out_slices, wx), _ceil_div(rows, wy)
    padded_flops = (gx * wx * 4) * (gy * wy) * reduction
    return GpuDispatch(kernel, wx, wy, gx, gy, out_slices * rows, padded_flops)


def gpu_latency_us(op: Op, dev: DeviceSpec) -> float:
    """Deterministic GPU latency model (microseconds)."""
    d = dispatch_for(op, dev)

    # --- occupancy: skinny problems cannot hide memory latency ---
    occupancy = min(1.0, d.total_threads /
                    (_OCCUPANCY_THREADS_PER_CU * dev.gpu_compute_units))
    # --- per-workgroup SIMD efficiency: tiny workgroups waste lanes ---
    # (floored: even the fallback workgroup keeps half the lanes busy; this
    # bounds heuristic-miss spikes near the paper's observed ~1.85x)
    wg_eff = max(0.5, min(1.0, d.wg_size / _FULL_EFF_THREADS))

    kernel_eff = {
        KERNEL_LINEAR: 1.0,
        KERNEL_CONV_GENERIC: 0.92,
        KERNEL_CONV_CONSTANT: 1.18,   # constant-memory broadcast of weights
        KERNEL_CONV_WINOGRAD: 0.80,   # transform overhead, worse locality
    }[d.kernel]

    eff_gflops = dev.gpu_gflops * kernel_eff * wg_eff * (occupancy ** 0.65)

    # Wave quantization: workgroups run in waves over the compute units.
    slots = dev.gpu_compute_units * max(1, int(512 // max(1, d.wg_size)))
    waves = _ceil_div(d.wg_count, slots)
    quant = (waves * slots) / max(1, d.wg_count)   # >=1, last-wave waste

    compute_us = d.padded_flops * quant / (eff_gflops * 1e3)

    # Memory traffic (unified memory; weights dominate for linear layers).
    if isinstance(op, LinearOp):
        padded_w = op.C_in * (d.grid_x * d.wg_x * 4) * 4.0
        bytes_total = op.input_bytes + padded_w + op.output_bytes
    else:
        reuse = 1.0 + 0.15 * (op.K * op.K - 1)   # halo re-reads via L1/texture
        if d.kernel == KERNEL_CONV_WINOGRAD:
            # 4x4 input tiles overlap by 2: ~4x input amplification, plus
            # Hadamard-domain intermediates.
            bytes_total = (4.0 * op.input_bytes + op.weight_bytes * (16 / 9)
                           + 2.0 * op.output_bytes)
        else:
            bytes_total = (reuse * op.input_bytes + op.weight_bytes
                           + op.output_bytes)
    mem_us = bytes_total / (dev.gpu_mem_gbps * 1e3)

    sched_us = _WG_SCHED_US * d.wg_count / dev.gpu_compute_units
    if d.kernel == KERNEL_CONV_WINOGRAD:
        # input/output transform passes are separate small kernels
        sched_us += 2 * dev.gpu_dispatch_us * 0.35

    return (dev.gpu_dispatch_us + sched_us
            + max(compute_us, mem_us) + 0.18 * min(compute_us, mem_us))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
