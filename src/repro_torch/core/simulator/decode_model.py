"""Analytic latency models for the decode-block kinds (attention / SSM).

The conv/linear models (`gpu_model.py` / `cpu_model.py`) capture the
paper's workgroup-heuristic and GEMM-tiling phenomena; decode attention
and SSD scans have different bottlenecks, modeled here:

  * **decode attention** is memory-bound on the KV cache (the query is a
    single position), so latency tracks cache traffic plus fixed dispatch
    cost.  The kernel *mode* changes the constant structure: ``streaming``
    fuses scores+softmax+weighted-sum into one pass (one dispatch, online
    softmax bookkeeping inflates compute ~12%), ``materialized`` runs two
    plain passes with the (H, S) scores matrix written and re-read.
  * **SSD scans** trade a sequential recurrence against chunked
    parallelism: ``recurrent`` pays a per-step cost that scales with T
    (cheap at T=1, the flash-linear-attention decode regime),
    ``chunked`` pays fixed chunk-setup overhead but runs the intra-chunk
    work at matrix-unit efficiency (wins for prefill-sized T).

Head-split / kv-block / state-split sub-ops (`AttnOp.with_heads`,
``with_cache``, `SSMOp.with_heads`) flow through these same formulas, so
the planner's (axis, split, mode) candidates are priced consistently.
Everything is deterministic given (device, op); measurement noise lives
in measure.py.
"""
from __future__ import annotations

from repro_torch.core.simulator.devices import DeviceSpec
from repro_torch.core.types import AttnOp, SSMOp

# Decode-shaped problems (a handful of rows) cannot fill the GPU: the
# effective throughput fraction at batch-1 decode occupancy.
_GPU_DECODE_OCCUPANCY = 0.25
# Online-softmax running max/sum bookkeeping, per the streaming mode.
_STREAMING_COMPUTE_OVERHEAD = 1.12
_CPU_STREAMING_OVERHEAD = 1.25
# Chunked SSD scans launch an intra-chunk pass and a state-carry pass.
_SSM_CHUNK = 256
_SSM_CHUNK_EFF_GPU = 0.45
_SSM_RECURRENT_EFF_GPU = 0.12
# Sequential recurrence: per-step scheduling cost on each backend.
_SSM_STEP_US_GPU = 0.9
_SSM_STEP_US_CPU = 0.08


def _attn_traffic_bytes(op: AttnOp) -> float:
    """KV cache + query/output activations; materialized mode adds the
    scores matrix (written by pass 1, re-read by pass 2)."""
    total = float(op.weight_bytes + op.input_bytes + op.output_bytes)
    if op.mode == "materialized":
        total += 2.0 * 4.0 * op.H * op.S
    return total


def attn_gpu_latency_us(op: AttnOp, dev: DeviceSpec) -> float:
    eff_gflops = dev.gpu_gflops * _GPU_DECODE_OCCUPANCY
    if op.mode == "streaming":
        dispatches = 1
        compute_us = (op.flops * _STREAMING_COMPUTE_OVERHEAD
                      / (eff_gflops * 1e3))
    else:
        dispatches = 2
        compute_us = op.flops / (eff_gflops * 1e3)
    mem_us = _attn_traffic_bytes(op) / (dev.gpu_mem_gbps * 1e3)
    return (dispatches * dev.gpu_dispatch_us
            + max(compute_us, mem_us) + 0.18 * min(compute_us, mem_us))


def attn_cpu_latency_us(op: AttnOp, dev: DeviceSpec, threads: int) -> float:
    threads = max(1, threads)
    # parallelism is over KV head groups — a 1-kv-head sub-op is serial
    active = min(threads, op.KV)
    gflops = dev.cpu_gflops(active)
    overhead = 1.0 if op.mode == "materialized" else _CPU_STREAMING_OVERHEAD
    compute_us = op.flops * overhead / (gflops * 1e3)
    mem_us = _attn_traffic_bytes(op) / (dev.cpu_mem_gbps * 1e3)
    fixed = dev.cpu_op_overhead_us * (1.0 + 0.35 * (threads - 1))
    return fixed + max(compute_us, mem_us) + 0.1 * min(compute_us, mem_us)


def _ssm_traffic_bytes(op: SSMOp) -> float:
    return float(op.input_bytes + op.weight_bytes + op.output_bytes)


def ssm_gpu_latency_us(op: SSMOp, dev: DeviceSpec) -> float:
    mem_us = _ssm_traffic_bytes(op) / (dev.gpu_mem_gbps * 1e3)
    if op.mode == "chunked":
        # intra-chunk pass + state-carry pass, each a dispatch
        dispatches = 2
        compute_us = (op.flops
                      / (dev.gpu_gflops * _SSM_CHUNK_EFF_GPU * 1e3))
        step_us = 0.0
    else:
        dispatches = 1
        compute_us = (op.flops
                      / (dev.gpu_gflops * _SSM_RECURRENT_EFF_GPU * 1e3))
        step_us = _SSM_STEP_US_GPU * op.T
    return (dispatches * dev.gpu_dispatch_us + step_us
            + max(compute_us, mem_us) + 0.18 * min(compute_us, mem_us))


def ssm_cpu_latency_us(op: SSMOp, dev: DeviceSpec, threads: int) -> float:
    threads = max(1, threads)
    # parallelism is across state heads (the scan is sequential in T)
    active = min(threads, op.H)
    gflops = dev.cpu_gflops(active)
    if op.mode == "chunked":
        # chunking trades a second sweep over the state for parallel form
        compute_us = op.flops * 1.15 / (gflops * 1e3)
        step_us = 0.0
    else:
        compute_us = op.flops / (gflops * 1e3)
        step_us = _SSM_STEP_US_CPU * op.T
    mem_us = _ssm_traffic_bytes(op) / (dev.cpu_mem_gbps * 1e3)
    fixed = dev.cpu_op_overhead_us * (1.0 + 0.35 * (threads - 1))
    return (fixed + step_us
            + max(compute_us, mem_us) + 0.1 * min(compute_us, mem_us))
