"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It fails (non-zero exit, no result line) when CUDA is unavailable or when
the port cannot be imported, and otherwise runs, in order:

1. the card's `nvidia-smi` name and power limit; TF32 off for matmuls and
   cuDNN, so every fp32 comparison is a full-fp32 one;
2. the build of every kernel from `src/repro_torch/csrc` (one nvcc per
   source, all at once), with ptxas's register/shared-memory report;
3. one phase per kernel at the main path's shapes plus ragged ones:
   the kernel against its plain PyTorch version in float32 and bfloat16,
   with kernel, plain and library (`torch.matmul` / `torch.bmm`) times
   from CUDA events (L2 flushed before every timed launch) and the bound
   the card's published rates give for the same work;
4. the main path: the committed VGG16 artifact loaded through
   `repro_torch.CompiledNetwork`, run at 224x224x3 on two CUDA-stream
   groups for a few seeded inputs ("requests"), each output held against
   `run_oracle` on the card, with the kernels' launch counters reset just
   before and read just after;
5. one more request under torch.profiler: device time by kernel;
6. a JSON line of per-kernel numbers, then the result line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARTIFACT = ROOT / "src/repro_torch/artifacts/vgg16_moto2022.coexec.json"

#: published dense peaks (NVIDIA data sheets): memory bytes/s and
#: operations/s by input type; fp32 runs outside the tensor cores (TF32 off)
PEAKS = {
    "sxm": {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12},
    "pcie": {"bytes": 2.0e12, "float32": 51e12, "bfloat16": 756e12},
}

#: kernel-vs-plain tolerance, relative to the largest |plain| value: fp32
#: sums of up to 25088 terms in another order differ by ~sqrt(K) * 2^-24;
#: bf16 outputs round to 8 bits, so one rounding step apart is 2^-8
KERNEL_RTOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}

#: seeded VGG16 inputs run through the main path (repeated: a stream-order
#: fault gives wrong answers only now and then)
REQUESTS = 4

#: end-to-end tolerance against run_oracle, relative to the largest |oracle|
#: value: Winograd reassociates every eligible conv's fp32 sums and the
#: split/unsplit kernels sum in other orders, across 16 layers and 5 pools
E2E_RTOL = 2e-3

#: (label, M, K, N, c0, width, on the main path): n18 is co-executed — each
#: group launches on its (25088, c_pad=3368) panel of the packed weights;
#: the rest are the same product on the full weight and ragged shapes
SPLIT_CASES = [
    ("n18 fast", 1, 25088, 3368, 0, 728, True),
    ("n18 slow", 1, 25088, 3368, 0, 3368, True),
    ("n19", 1, 4096, 4096, 0, 4096, True),
    ("n20", 1, 4096, 1000, 0, 1000, True),
    ("n18 fast, full W", 1, 25088, 4096, 0, 728, False),
    ("n18 slow, full W", 1, 25088, 4096, 728, 3368, False),
    ("ragged M=17", 17, 100, 301, 96, 128, False),
    ("ragged M=50", 50, 768, 3072, 2480, 592, False),
]

#: (label, P, K, N, launches per run): P = ceil(H/2) * ceil(W/2) tiles
HADAMARD_CASES = [
    ("n3", 56 * 56, 64, 128, 1),
    ("n4", 56 * 56, 128, 128, 1),
    ("n6 fast", 28 * 28, 128, 192, 1),
    ("n6 slow", 28 * 28, 128, 64, 1),
    ("n7/n8", 28 * 28, 256, 256, 2),
    ("ragged", 37, 40, 136, 0),
    ("ragged P=1", 1, 32, 200, 0),
]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_peaks() -> dict:
    name = torch.cuda.get_device_name(0)
    return PEAKS["pcie"] if "PCIe" in name else PEAKS["sxm"]


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype, peaks: dict):
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = ops / peaks[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


_FLUSH = None


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of one call, each launch timed by its own CUDA
    events after a 128 MB write that evicts the 50 MB L2 cache."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(32 * 1024 * 1024, device="cuda")
    times = []
    for i in range(reps + 2):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(label: str, got: torch.Tensor, want: torch.Tensor,
          rtol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not np.isfinite(err) or err > rtol * scale:
        raise AssertionError(f"{label}: max |kernel - plain| = {err:.3e} "
                             f"> {rtol:g} x {scale:.3g}")
    return err


def split_matmul_phase(peaks: dict) -> dict:
    from repro_torch.kernels.split_matmul.split_matmul import (
        split_matmul, split_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(11)
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "t_bytes": 0.0, "t_ops": 0.0, "max_abs_err": 0.0,
           "max_abs_err_bf16": 0.0}
    for label, m, k, n, c0, width, main in SPLIT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            err = check(f"split_matmul {label} {dtype}",
                        split_matmul(x, w, c0, width),
                        split_matmul_plain(x, w, c0, width),
                        KERNEL_RTOL[dtype])
            ms = time_ms(lambda: split_matmul(x, w, c0, width))
            plain = time_ms(lambda: split_matmul_plain(x, w, c0, width))
            lib = time_ms(lambda: torch.matmul(x, w[:, c0:c0 + width]))
            size = x.element_size()
            bnd, tb, to = bound_ms(
                size * (m * k + k * width + m * width), 2 * m * k * width,
                dtype, peaks)
            print(f"split_matmul {label:18s} {str(dtype)[6:]:8s} "
                  f"M={m} K={k} N={n} c0={c0} width={width}: "
                  f"max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
                  f"{plain:.4f} ms library {lib:.4f} ms bound {bnd:.4f} ms",
                  flush=True)
            if dtype == torch.bfloat16:
                agg["max_abs_err_bf16"] = max(agg["max_abs_err_bf16"], err)
            elif main:
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", bnd),
                               ("t_bytes", tb), ("t_ops", to)):
                    agg[key] += v
    return agg


def hadamard_phase(peaks: dict) -> dict:
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul, hadamard_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(12)
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "t_bytes": 0.0, "t_ops": 0.0, "max_abs_err": 0.0,
           "max_abs_err_bf16": 0.0}
    for label, p, k, n, per_run in HADAMARD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.randn((16, p, k), generator=gen, device="cuda").to(dtype)
            v = (torch.randn((16, k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            err = check(f"hadamard_matmul {label} {dtype}",
                        hadamard_matmul(u, v), hadamard_matmul_plain(u, v),
                        KERNEL_RTOL[dtype])
            ms = time_ms(lambda: hadamard_matmul(u, v))
            plain = time_ms(lambda: hadamard_matmul_plain(u, v))
            lib = time_ms(lambda: torch.bmm(u, v))
            size = u.element_size()
            bnd, tb, to = bound_ms(
                size * 16 * (p * k + k * n + p * n), 2 * 16 * p * k * n,
                dtype, peaks)
            print(f"hadamard_matmul {label:10s} {str(dtype)[6:]:8s} "
                  f"P={p} K={k} N={n}: max_abs_err {err:.3e} kernel "
                  f"{ms:.4f} ms plain {plain:.4f} ms library {lib:.4f} ms "
                  f"bound {bnd:.4f} ms", flush=True)
            if dtype == torch.bfloat16:
                agg["max_abs_err_bf16"] = max(agg["max_abs_err_bf16"], err)
            elif per_run:
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", bnd),
                               ("t_bytes", tb), ("t_ops", to)):
                    agg[key] += v * per_run
    return agg


def main_path(requests: int):
    """The VGG16 artifact on two CUDA-stream groups, `requests` seeded
    inputs, each held against run_oracle; returns the launch counts and
    the executor."""
    import repro_torch
    from repro_torch.kernels.winograd_conv.ops import winograd_eligible
    from repro_torch.kernels.split_matmul.split_matmul import split_matmul
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul)

    t0 = time.perf_counter()
    compiled = repro_torch.CompiledNetwork.load(ARTIFACT)
    exe = compiled.executor(device="cuda")
    print(f"vgg16: loaded {ARTIFACT.name} (key {compiled.key}), weights on "
          f"{exe.device} in {time.perf_counter() - t0:.1f} s; groups "
          f"{len(exe.groups)}", flush=True)
    if not exe.split_capable:
        raise AssertionError("the main path needs two co-execution groups")
    exe.run(warmup=True)                       # builds, cuDNN choice

    split_matmul.launches = hadamard_matmul.launches = 0
    per_run = []
    outputs = []
    for r in range(requests):
        rng = np.random.default_rng(100 + r)
        x = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
        before = (split_matmul.launches, hadamard_matmul.launches)
        t = time.perf_counter()
        y, rep = exe.run(x)
        wall = (time.perf_counter() - t) * 1e3
        per_run.append((split_matmul.launches - before[0],
                        hadamard_matmul.launches - before[1]))
        outputs.append((x, y, rep, wall))
    counts = {"split_matmul": split_matmul.launches,
              "hadamard_matmul": hadamard_matmul.launches}

    for r, ((x, y, rep, wall), (n_sm, n_hm)) in enumerate(
            zip(outputs, per_run)):
        want = exe.run_oracle(x)
        torch.cuda.synchronize()
        if tuple(y.shape) != (1, 1000) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"request {r}: output {tuple(y.shape)} "
                                 f"is not a finite (1, 1000) tensor")
        err = float((y - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if err > E2E_RTOL * scale:
            raise AssertionError(f"request {r}: max |run - run_oracle| = "
                                 f"{err:.3e} > {E2E_RTOL} x {scale:.3g}")
        if (n_sm, n_hm) != (4, 6):
            raise AssertionError(f"request {r}: {n_sm} split_matmul and "
                                 f"{n_hm} hadamard_matmul launches, want 4 "
                                 f"and 6")
        if (rep.reshard_points, rep.elided) != (4, 4):
            raise AssertionError(f"request {r}: {rep.reshard_points} "
                                 f"reshard points, {rep.elided} elided; "
                                 f"want 4 and 4")
        share = {}
        for t, spec in zip(rep.timings, exe.specs):
            if spec.unit == "conv":
                kind = ("winograd conv" if winograd_eligible(spec.op)
                        else "direct conv")
            else:
                kind = spec.unit
            share[kind] = share.get(kind, 0.0) + t.wall_us
        parts = ", ".join(f"{k} {v / rep.wall_us:.1%}"
                          for k, v in sorted(share.items()))
        print(f"vgg16 request {r}: wall {wall:.3f} ms (nodes "
              f"{rep.wall_us / 1e3:.3f} ms: {parts}); max_abs_err "
              f"{err:.3e} (scale {scale:.3g}); launches split_matmul "
              f"{n_sm} hadamard_matmul {n_hm}; reshard "
              f"{rep.reshard_points} elided {rep.elided} syncs "
              f"{rep.sync_points}", flush=True)
    walls = sorted(o[3] for o in outputs)
    print(f"vgg16: median request wall {statistics.median(walls):.3f} ms "
          f"over {requests} requests (min {walls[0]:.3f}, max "
          f"{walls[-1]:.3f})", flush=True)
    return counts, exe


def device_breakdown(exe, top: int = 12) -> None:
    """One VGG16 request under torch.profiler: device time of the kernels
    it ran, by kernel name, against the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = np.random.default_rng(200).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    exe.run(x)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        exe.run(x)
        wall = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: request wall {wall:.3f} ms under the profiler; kernels "
          f"{busy:.3f} ms of device time in {sum(r[1] for r in rows)} "
          f"launches (the two streams may overlap)")
    for ms, count, key in rows[:top]:
        print(f"  {ms:8.3f} ms {count:4d}x {key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    print(nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build(build.KERNELS, ptxas_verbose=True)
    print(f"build: {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s -> {build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    peaks = card_peaks()
    results = {"split_matmul": split_matmul_phase(peaks),
               "hadamard_matmul": hadamard_phase(peaks)}
    counts, exe = main_path(REQUESTS)
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    device_breakdown(exe)

    sources = {
        "split_matmul": ("src/repro_torch/csrc/split_matmul.cu",
                         "src/repro/kernels/split_matmul/split_matmul.py:44"),
        "hadamard_matmul": (
            "src/repro_torch/csrc/hadamard_matmul.cu",
            "src/repro/kernels/winograd_conv/winograd_conv.py:55"),
    }
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": sources[name][0],
        "replaces": sources[name][1], "launches": counts[name],
        "max_abs_err": r["max_abs_err"],
        "max_abs_err_bf16": r["max_abs_err_bf16"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
        "library_ms": r["library_ms"],
        "per": "one VGG16 run's launches, float32"}
        for name, r in results.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
