"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  A run:

1. builds the cell's driver, makes the seed's weights and inputs, and
   warms up every shape the cell's traffic uses (set-up: `setup_s` runs
   from the process's start to the first timed call);
2. measures a closed loop for `--seconds`: each call is dispatched when
   the last returns; no call starts after the time is up, and the window
   ends when the last one returns;
3. with `--trace 1`, then profiles `trace_calls` more calls
   (`trace.py`);
4. reads the peak device memory, frees the program's state, and compares
   the outputs the window produced with the plain reference
   (`compare.py`, the cell's `limits/<cell>.json`);
5. prints each compared number beside its limit as its last lines on
   standard error, and as the last line of standard output one JSON
   object: `correct`, `attempted`, `failed`, `metrics` (the cell's
   end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
   with `--trace 1` `breakdown`, and last `checks`.

It exits 2 without a result where CUDA is missing or has fewer cards than
the cell asks for, and 3 where `jax`, `jaxlib`, `flax` or the JAX
package `repro` was imported.  Every cache lies in fixed folders inside
the checkout (`build/`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

_T_IMPORT = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent

#: top-level module names a run may not import (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: caches of anything the program might compile, fixed inside the checkout
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def process_age_s() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))


_AGE_AT_IMPORT = process_age_s()


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Call:
    i: int
    t0: float
    t1: float
    requests: int
    failed: bool
    counters: Dict[str, Any]

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    driver: Any
    device_name: str
    calls: List[Call]
    window_s: float
    setup_s: float
    trace: Any = None                  # trace.Trace of the traced slice
    traced_first: int = 0              # the traced slice's first call
    traced: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def precision(self) -> str:
        return self.driver.precision

    def compute_peak(self) -> float:
        from portbench import peaks
        return peaks.compute_peak(self.device_name, self.precision)

    def memory_peak(self) -> float:
        from portbench import peaks
        return peaks.memory_peak(self.device_name)

    def completed(self) -> List[Call]:
        return [c for c in self.calls if not c.failed]

    def latencies_ms(self) -> List[float]:
        """Every request's latency (its call's), inf for a failed one."""
        out: List[float] = []
        for c in self.calls:
            out += [math.inf if c.failed else c.ms] * c.requests
        return out


def window(drv, seconds: float, sync) -> List[Call]:
    """The closed loop: call i is dispatched when call i - 1 returned; the
    last call starts before `seconds` have passed."""
    calls: List[Call] = []
    start = None
    i = 0
    while True:
        payload = drv.make(i)
        t0 = time.perf_counter()
        start = t0 if start is None else start
        try:
            out = drv.call(i, payload)
            failed = False
        except Exception:                       # a failed call is counted
            traceback.print_exc(limit=4, file=sys.stderr)
            out = {"requests": drv.mix["batch"], "counters": {}}
            failed = True
            sync_quietly(sync)
        t1 = time.perf_counter()
        calls.append(Call(i, t0, t1, out["requests"], failed,
                          out["counters"]))
        i += 1
        if t1 - start >= seconds:
            return calls


def sync_quietly(sync) -> None:
    try:
        sync()
    except RuntimeError:
        traceback.print_exc(limit=2, file=sys.stderr)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def execute(manifest_doc: Dict[str, Any], cell: Dict[str, Any], seed: int,
            seconds: float, traced: bool, device: str,
            config: Optional[Dict[str, Any]] = None,
            mix: Optional[Dict[str, Any]] = None,
            limits: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """One run of `cell` on `device`; returns the result object.  Tests
    pass a smaller `config`, `mix` and `limits` and `device="cpu"`."""
    import torch

    from portbench import compare, manifest, traffic
    from portbench import trace as tracing

    config = config or manifest.config(cell["config"])
    mix = traffic.mix(mix or manifest.traffic(cell["traffic"]))
    limits = limits if limits is not None else manifest.limits(cell["name"])
    on_card = torch.device(device).type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    set_tf32(config)
    drv = manifest.driver(config["driver"]).Driver(config, mix, device)
    drv.prepare(seed)
    drv.warmup()
    sync()
    calls = window(drv, seconds, sync)
    setup_s = _AGE_AT_IMPORT + (calls[0].t0 - _T_IMPORT)
    run = Run(cell, config, mix, drv,
              torch.cuda.get_device_name(device) if on_card else "cpu",
              calls, calls[-1].t1 - calls[0].t0, setup_s)
    if traced:
        first = run.traced_first = len(calls)
        payloads = {i: drv.make(i)
                    for i in range(first, first + mix["trace_calls"])}
        run.trace = tracing.profile(
            lambda i: run.traced.append(drv.call(i, payloads[i],
                                                 keep=False)),
            first, mix["trace_calls"], sync)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = compare.judge(drv.check(), limits)
    attempted = sum(c.requests for c in calls)
    failed = sum(c.requests for c in calls if c.failed)
    metrics: Dict[str, Any] = {}
    for m in manifest.metrics_for(manifest_doc, cell["name"], traced):
        value = manifest.reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": "gpu" if on_card else "cpu",
                           "kind": run.device_name,
                           "count": cell["chips"],
                           "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {
        "correct": failed == 0 and compare.passed(checks),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    dev["window_calls"] = len(calls)
    result["checks"] = {k: {"value": finite(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    return result


def finite(x: float) -> float:
    """x, with a value that is not finite (an output that was missing or
    not a number) written as the largest double, which fails any
    limit."""
    return x if math.isfinite(x) else sys.float_info.max


def set_tf32(config: Dict[str, Any]) -> None:
    """A configuration that states fp32 with TF32 off runs with it off."""
    import torch

    if config.get("tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def prepare_process() -> None:
    """Fixed cache folders inside the checkout, and the port's package on
    the path: before torch is imported."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare_process()
    import torch

    from portbench import manifest

    doc = manifest.load(ROOT)
    try:
        cell = manifest.cell(doc, args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(doc, cell, args.seed, args.seconds, bool(args.trace),
                     "cuda")
    found = forbidden_modules(sys.modules)
    if found:
        print(f"the run imported {found}: neither JAX nor the JAX package "
              f"may be loaded", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
