"""XNNPACK-style CPU cost model.

The paper's key empirical observation (Fig. 2) is that mobile CPUs running
XNNPACK's NEON GEMM/IGEMM kernels are competitive with the GPU for many
linear operations.  XNNPACK tiles the output into MR x NR register blocks
(f32 NEON: 6x8) and parallelizes over output-channel tile groups, so the CPU
latency curve is smooth in C_out except for mild quantization from tile and
thread-chunk granularity.
"""
from __future__ import annotations

from repro_torch.core.simulator.devices import DeviceSpec
from repro_torch.core.types import LinearOp, Op

_MR, _NR = 6, 8            # XNNPACK f32 NEON GEMM register tile
_L2_BYTES = 1.5e6          # per-core effective L2/SLC working-set knee


def cpu_latency_us(op: Op, dev: DeviceSpec, threads: int) -> float:
    """Deterministic CPU latency model (microseconds) for 1..n threads."""
    threads = max(1, threads)
    if isinstance(op, LinearOp):
        rows, red, cols = op.L, op.C_in, op.C_out
        in_bytes, w_bytes, out_bytes = (op.input_bytes, op.weight_bytes,
                                        op.output_bytes)
    else:
        # IGEMM view of convolution: rows = output pixels, reduction = K*K*Cin.
        rows, red, cols = op.H_out * op.W_out, op.K * op.K * op.C_in, op.C_out
        in_bytes = op.input_bytes * (1.0 + 0.1 * (op.K * op.K - 1))
        w_bytes, out_bytes = op.weight_bytes, op.output_bytes

    # Tile-padding waste (marginal, but keeps the model honest).
    padded_rows = -(-rows // _MR) * _MR
    padded_cols = -(-cols // _NR) * _NR
    flops = 2.0 * padded_rows * padded_cols * red

    # Thread-chunk quantization: XNNPACK splits the NR-tile grid across
    # threads; with few column tiles the split is imbalanced and the extra
    # threads simply idle (they do not slow the busy ones down).
    col_tiles = max(1, padded_cols // _NR)
    active = min(threads, col_tiles)
    chunks = -(-col_tiles // active)
    balance = col_tiles / (chunks * active)

    gflops = dev.cpu_gflops(active) * balance
    # Working sets that spill the shared L2/SLC run closer to DRAM speed.
    ws = in_bytes + w_bytes + out_bytes
    locality = 1.0 if ws <= _L2_BYTES * threads else 0.88
    compute_us = flops / (gflops * locality * 1e3)

    mem_us = (in_bytes + w_bytes + out_bytes) / (dev.cpu_mem_gbps * 1e3)

    # Thread wake-up/teardown cost grows mildly with the thread count.
    overhead = dev.cpu_op_overhead_us * (1.0 + 0.35 * (threads - 1))
    return overhead + max(compute_us, mem_us) + 0.1 * min(compute_us, mem_us)
