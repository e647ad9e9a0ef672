"""Calibrated performance specifications of the paper's four mobile platforms.

There is no mobile SoC to measure, so the paper's measurement substrate is
replaced by a *white-box performance model* of each platform.  The constants
below are the reference's calibration, value for value, chosen so that
the simulated latency curves reproduce the paper's *qualitative and
quantitative* phenomena:

  * Fig. 2  — CPU(3 threads) beats GPU for (50,3072)x(3072,C) when C < ~425
              on OnePlus 11;
  * Fig. 5/6 — discontinuous GPU latency spikes from workgroup heuristics and
              kernel switching;
  * Tab. 2  — co-execution speedup ordering Pixel 5 > Pixel 4 > Moto 2022 >
              OnePlus 11 (larger CPU/GPU performance gap => lower speedup);
  * Sec. 4  — event-notification sync overhead ~162 us vs fine-grained SVM
              polling ~7 us (Moto 2022).

Throughputs are *effective* (achievable) rather than datasheet-peak numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    # --- GPU (TFLite OpenCL delegate model) ---
    gpu_gflops: float              # effective fp16/fp32 MAD throughput, GFLOP/s
    gpu_compute_units: int         # number of shader cores / CUs
    gpu_mem_gbps: float            # effective memory bandwidth seen by the GPU
    gpu_dispatch_us: float         # fixed per-kernel dispatch/driver latency
    gpu_constant_mem_kb: int       # on-chip constant memory (conv_constant)
    # --- CPU (XNNPACK model) ---
    cpu_gflops_per_core: float     # effective NEON fp32 throughput per big core
    cpu_big_cores: int
    cpu_mem_gbps: float            # effective memory bandwidth seen by the CPU
    cpu_thread_eff: Tuple[float, ...]  # parallel efficiency for 1..n threads
    cpu_op_overhead_us: float      # per-op XNNPACK scheduling overhead
    # --- synchronization (Section 4) ---
    sync_event_us: float           # clWaitForEvents-style notification delay
    sync_svm_us: float             # fine-grained SVM active-polling overhead

    def cpu_gflops(self, threads: int) -> float:
        threads = max(1, min(threads, self.cpu_big_cores))
        return self.cpu_gflops_per_core * threads * self.cpu_thread_eff[threads - 1]


# Calibration notes:
#  - Pixel 5 pairs a mid-range GPU (Adreno 620) with the same CPU class as
#    Pixel 4, hence the narrowest GPU/CPU gap and the best co-exec speedups.
#  - OnePlus 11 (Adreno 740) has the widest gap, hence the smallest speedups.
#  - sync_* for Moto 2022 matches the paper's measured 162 us / 7 us.
DEVICES: Dict[str, DeviceSpec] = {
    "pixel4": DeviceSpec(
        name="pixel4",
        gpu_gflops=150.0, gpu_compute_units=2, gpu_mem_gbps=14.0,
        gpu_dispatch_us=35.0, gpu_constant_mem_kb=48,
        cpu_gflops_per_core=58.0, cpu_big_cores=4, cpu_mem_gbps=12.0,
        cpu_thread_eff=(1.0, 0.95, 0.90, 0.82), cpu_op_overhead_us=11.0,
        sync_event_us=148.0, sync_svm_us=7.5,
    ),
    "pixel5": DeviceSpec(
        name="pixel5",
        gpu_gflops=102.0, gpu_compute_units=1, gpu_mem_gbps=12.0,
        gpu_dispatch_us=30.0, gpu_constant_mem_kb=48,
        cpu_gflops_per_core=52.0, cpu_big_cores=2, cpu_mem_gbps=11.0,
        # Pixel 5 has 2 big (A76) + 6 little cores; thread 3 lands on a
        # little core, hence the strong efficiency drop at 3 threads.
        cpu_thread_eff=(1.0, 0.93, 0.78, 0.66), cpu_op_overhead_us=12.0,
        sync_event_us=155.0, sync_svm_us=8.0,
    ),
    "moto2022": DeviceSpec(
        name="moto2022",
        gpu_gflops=370.0, gpu_compute_units=3, gpu_mem_gbps=28.0,
        gpu_dispatch_us=24.0, gpu_constant_mem_kb=64,
        cpu_gflops_per_core=82.0, cpu_big_cores=4, cpu_mem_gbps=22.0,
        cpu_thread_eff=(1.0, 0.94, 0.88, 0.80), cpu_op_overhead_us=9.0,
        sync_event_us=162.0, sync_svm_us=7.0,   # Section 4: 162 us -> 7 us
        ),
    "oneplus11": DeviceSpec(
        name="oneplus11",
        gpu_gflops=500.0, gpu_compute_units=4, gpu_mem_gbps=34.0,
        gpu_dispatch_us=20.0, gpu_constant_mem_kb=64,
        cpu_gflops_per_core=80.0, cpu_big_cores=5, cpu_mem_gbps=26.0,
        cpu_thread_eff=(1.0, 0.95, 0.89, 0.82, 0.75), cpu_op_overhead_us=8.0,
        sync_event_us=150.0, sync_svm_us=6.5,
    ),
}

# Pixel 5's big-core count is 2, but the paper runs up to 3 CPU threads on
# every device; thread_eff above already encodes the little-core penalty, so
# allow up to len(cpu_thread_eff) threads everywhere.
for _d in DEVICES.values():
    object.__setattr__(_d, "cpu_big_cores", len(_d.cpu_thread_eff))
