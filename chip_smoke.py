"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                  # everything
    python3 chip_smoke.py --kernels-only   # build and kernel phases only

It fails (non-zero exit, no result line) when CUDA is unavailable or when
the port cannot be imported, and otherwise runs, in order:

1. the card's `nvidia-smi` name and power limit; TF32 off for matmuls and
   cuDNN, so every fp32 comparison is a full-fp32 one;
2. the build of every kernel from `src/repro_torch/csrc` (one nvcc per
   source, all at once), with ptxas's register/shared-memory report;
3. one phase per kernel at the main paths' shapes plus off-path ones
   (each case through that kernel's `hold_*`):
   the kernel against its plain PyTorch version in float32 and bfloat16,
   with kernel, plain and library (`torch.matmul`, `torch.bmm`,
   `scaled_dot_product_attention`; none for the SSD scan) device times
   from CUDA events (`time_ms`: L2 flushed before every timed call, host
   launch time kept out), the bound the card's published rates give for
   the same work and the kernel's share of it (bound / kernel time), and
   each case's launch plan; `split_matmul` and `decode_attention` are
   also called twice on the same inputs and must give bit-identical
   outputs (their split reductions are deterministic); the SSD scan's
   decode and chunk kernels are both timed at T = 1 and T =
   `DECODE_T_MAX`, beside the time `time_ms` gives an empty kernel (the
   floor of any launch);
4. the compile phase, on the host: each main path compiled by
   `repro_torch.compile` (no JAX) for its committed artifact's `Target`,
   into a fresh plan cache and predictor cache, its document held equal
   to the committed artifact's (checksum included), then compiled again
   from the warm plan cache; cold and warm seconds, the host's CPU model
   (`lscpu`) and numpy's version printed;
5. five main paths (`PATHS`), each running the network the port compiled
   in phase 4 (strict: the port's static verifier checks its plan) on two
   CUDA-stream groups for a few seeded inputs ("requests"), each output
   held against `run_oracle` on the card, with every kernel's launch
   counter set to 0 just before the path and read just after:
   - VGG16 at 224x224x3 (`split_matmul`, `hadamard_matmul`);
   - a zamba2-7b decode step, 9 blocks, 4096-position KV cache
     (`split_matmul`, `decode_attention` on both sides of a kv-block split,
     `ssd_chunk_scan`);
   - resnet18 and resnet34 at 224x224x3 (`split_matmul`; direct convs on
     two streams, projection shortcuts through `_adapt`);
   - inception_v3 at 299x299x3 (`split_matmul`, `hadamard_matmul` on both
     sides of its one Winograd node; 68 fused segments);
6. two more requests of each path under torch.profiler: device time by
   kernel, and each kernel's launches in the trace beside its counter;
7. the fused segment walk of each path (`run(fused=True)`): every fused
   segment captured once as a CUDA graph (each printed with its kind, its
   nodes and the kernel launches its graph holds), then the same seeded
   requests, each output `torch.equal` to the per-node walk's and within
   `E2E_RTOL` of `run_oracle`, with the per-node walk's launch counts
   (credited at each replay), the reshard and elided counts over its
   channel splits (`fused_reshard_counts`) and one sync per segment; the
   two walks' median walls from one alternating run (per-node, fused,
   per-node, fused, ...); two fused requests under
   torch.profiler, with each kernel's launches in the trace beside its
   credited counter and the graph launches the trace shows;
8. a bfloat16 run of VGG16 and the zamba2-7b step (`BF16_PATHS`):
   `executor(dtype="bfloat16")`, per-node and fused, `BF16_REQUESTS`
   requests each, held against the float32 `run_oracle` at `BF16_RTOL`
   of its largest |value|, with the same launch counts;
9. the `calibrate` phase, on VGG16 and the zamba2-7b step
   (`CALIBRATE_PATHS`, the networks phase 4 compiled, which carry their
   predictors): `RECORD_RUNS` per-node runs and one fused run recorded
   into a fresh measurement store (each kernel launched that many times
   the plan's count), `recalibrate()` with its corrections, record count,
   the fidelity error before and after the fit over the card's records
   (after <= before) and the calibrator's version; `replan()` with its
   `PlanDiff`, the nodes that moved their axis or boundary and the host
   seconds; the replanned plan saved and loaded back strictly, then run
   per node and fused as a main path is (`REPLAN_REQUESTS` requests each,
   within `E2E_RTOL` of its own `run_oracle`, fused `torch.equal` to
   per-node, counts `expected_counts` of the replanned plan), every
   kernel call of one more request captured (`kernel_calls`) and each
   distinct call held against its plain version in float32 and bfloat16
   with its times and bound (`hold_walk_calls`); and the original and
   replanned plans' walls in turns, with no claim;
10. the `portfolio` phase: the committed zamba2-7b portfolio
   (`PORTFOLIO`) compiled on this host by `compile_portfolio` into fresh
   caches, its document equal to the committed one (checksum included),
   compiled again as all warm hits, cold and warm seconds printed; then
   the file loaded strictly and each of its three entries (batch 1 and 4,
   64- and 256-position caches), picked by `select`, run per node and
   fused as a main path is (`PORTFOLIO_REQUESTS` requests each), its
   kernel calls held as in phase 9; then the in-process portfolio's entry
   for the live step `PORTFOLIO_STEP` taken through phase 9's loop and
   swapped in with `replace`, the new document loaded back strictly;
11. the `serve` phase (`serve_phase`): codeqwen1.5-7b (`SERVE_ARCH`) at
   its published widths and full depth (32 layers, d_model 4096, 32 heads
   of 128, d_ff 13440, vocab 92416: 8.2 B parameters), its weights seeded
   draws made on the card.  A portfolio (`SERVE_BUCKETS`, b1s64 and
   b4s64) compiled on this host, cold then warm; each entry's plan run as
   a main path is (`main_path`: its `split_matmul` and `decode_attention`
   calls at H = KV = 32, hd = 128) and every kernel call of one of its
   requests held against its plain version in float32 and bfloat16
   (`hold_walk_calls`); the reduced model's prefill and decode logits on
   the card within `SERVE_LOGIT_RTOL` of the same weights on the CPU; in
   fp32, `ContinuousScheduler` on the virtual clock over `SERVE_TRAFFIC`
   greedy Poisson requests (0.33 / the b4s64 plan's cost, the reference's
   acceptance rate), its plans executed every `SERVE_FIDELITY_EVERY`
   steps, each completion equal token for token to the request served
   alone by the fixed-batch engine (on a mismatch the solo run's top-2
   logit gap there is printed); in bf16, the fixed-batch `ServingEngine`
   on `SERVE_FIXED_REQUESTS` requests (greedy and T = 0.7 in turns)
   shipping the b4s64 entry (`compiled=`, one `execute_plan`), then the
   scheduler on the wall clock: tokens/s, TTFT p50, latency p50/p99 and
   peak memory beside the card's name and power limit, and its offered
   load against the slots the card served (`offered_load`: that traffic
   is paced by the phone's plan cost, so on the card it overloads the
   scheduler and the wall figures are a backlog's); a decode step at
   batch 1 and 4 timed bare and under torch.profiler (device time by
   kernel, idle share, host launch calls); then the scheduler again on
   the virtual clock with a `ThrottleSim` (x2.5 from 100 steps' cost on):
   at least one drift-triggered in-place replan must be committed, with
   a lower fidelity error.  Every plan those runs executed
   (`executed_plans`: fidelity runs, replan candidates committed or not,
   the engine's `execute_plan`, on any of the three scheduler runs) that
   the entries did not hold runs as a main path with its kernel calls
   held.  Each serve walk's launch counts are set
   to 0 just before it and read just after, and `split_matmul` and
   `decode_attention` must launch in each;
12. the `tune` phase (`tune_phase`): (a) a sweep of one op per kind at
   the paths' shapes (`tune_ops`: VGG16's n7 Winograd conv, a zamba2-7b
   GEMV at M = 1 and M = 4, an M = 64 linear for the tiled product, the
   zamba2-7b b8.attn fast side at S = 3072, the SSD chunk kernel at
   T = 4096): every candidate of the kind's Hopper launch spec
   (`repro_torch.kernels.tiles`, both search modes) held against the
   plain version in float32 and bfloat16, each output-tiling one
   `torch.equal` to the default launch in float32, each timed, with the
   default's time, the winner of each search mode and its bound; (b)
   `compile(tune=True)` of VGG16 and the zamba2-7b step into fresh caches
   with the measurements counted, cold then warm (no measurement, tune
   hits only), the tuned key against the untuned one and the documents
   equal but for `provenance.tune`; the tuned artifact saved with its
   sidecar, loaded strictly and run per node and fused as a main path
   is, every kernel call of one request carrying its op's tuned launch
   (`expected_launches`); the same plan tuned with its reduction axes
   too (`preserve_numerics=False`: split-K factors, runs, chunks), run
   alike and its kernel calls held against their plain versions
   (`hold_walk_calls`); tuned, relaxed and untuned walls in turns, no
   claim;
13. a JSON line of per-kernel numbers (launches summed over every walk
   above, `by_path` per walk with the float32 times of one request where
   the walk's calls were held), then the result line.  Each phase prints
   its seconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARTIFACTS = ROOT / "src/repro_torch/artifacts"
ARTIFACT = ARTIFACTS / "vgg16_moto2022.coexec.json"
ZAMBA_ARTIFACT = ARTIFACTS / "zamba2-7b_b9_s4096_moto2022_t1.coexec.json"

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

#: seeded inputs run through each main path (repeated: a stream-order
#: fault gives wrong answers only now and then)
REQUESTS = 4

VGG, ZAMBA = "vgg16", "zamba2-7b"
R18, R34, INC = "resnet18", "resnet34", "inception_v3"

#: end-to-end tolerance against run_oracle, relative to the largest |oracle|
#: value.  VGG16: Winograd reassociates every eligible conv's fp32 sums and
#: the split/unsplit kernels sum in other orders, across 16 layers and 5
#: pools.  zamba2-7b: split/unsplit fp32 GEMV sums (K up to 14336), the
#: chunked SSD form against the step-by-step scan, and the kv-block
#: log-sum-exp merge, through 9 residual blocks.  The resnets and
#: inception_v3: the same fp32 reorderings (split and unsplit direct convs,
#: inception's one Winograd node), held to the VGG16 bound.
E2E_RTOL = {VGG: 2e-3, ZAMBA: 1e-4, R18: 2e-3, R34: 2e-3, INC: 2e-3}


#: per-node/fused request pairs of the alternating wall measurement
WALL_PAIRS = 8

#: the bfloat16 phase: its paths, requests per walk, and its tolerance
#: against the float32 run_oracle relative to the largest |oracle| value
#: (the reference's own bf16 end-to-end tolerance)
BF16_PATHS = (VGG, ZAMBA)
BF16_REQUESTS = 2
BF16_RTOL = 5e-2

#: every kernel of the port, by its launch counter's name
KERNEL_NAMES = ("split_matmul", "hadamard_matmul", "decode_attention",
                "ssd_chunk_scan")

#: (label, M, K, N, c0, width, launches per request by main path).  A
#: co-executed linear launches once per group on its (K, c_pad) panel of
#: the packed weights; exclusive ones on the full weight
SPLIT_CASES = [
    ("n18 fast", 1, 25088, 3368, 0, 728, {VGG: 1}),
    ("n18 slow", 1, 25088, 3368, 0, 3368, {VGG: 1}),
    ("n19", 1, 4096, 4096, 0, 4096, {VGG: 1}),
    ("n20", 1, 4096, 1000, 0, 1000, {VGG: 1}),
    ("embed/q_proj/o_proj", 1, 3584, 3584, 0, 3584, {ZAMBA: 3}),
    ("in_proj fast", 1, 3584, 5696, 0, 1472, {ZAMBA: 8}),
    ("in_proj slow", 1, 3584, 5696, 0, 5696, {ZAMBA: 8}),
    ("out_proj fast", 1, 7168, 2528, 0, 1056, {ZAMBA: 8}),
    ("out_proj slow", 1, 7168, 2528, 0, 2528, {ZAMBA: 8}),
    ("mlp_up fast", 1, 3584, 9200, 0, 5136, {ZAMBA: 1}),
    ("mlp_up slow", 1, 3584, 9200, 0, 9200, {ZAMBA: 1}),
    ("mlp_down fast", 1, 14336, 2296, 0, 1288, {ZAMBA: 1}),
    ("mlp_down slow", 1, 14336, 2296, 0, 2296, {ZAMBA: 1}),
    ("resnet fc", 1, 512, 1000, 0, 1000, {R18: 1, R34: 1}),
    ("inception fc", 1, 2048, 1000, 0, 1000, {INC: 1}),
    ("n18 fast, full W", 1, 25088, 4096, 0, 728, {}),
    ("n18 slow, full W", 1, 25088, 4096, 728, 3368, {}),
    ("scalar c0=3 M=4", 4, 4096, 1000, 3, 997, {}),
    ("ragged M=17", 17, 100, 301, 96, 128, {}),
    ("ragged M=50", 50, 768, 3072, 2480, 592, {}),
]

#: (label, P, K, N, launches per request): P = ceil(H/2) * ceil(W/2) tiles
HADAMARD_CASES = [
    ("n3", 56 * 56, 64, 128, {VGG: 1}),
    ("n4", 56 * 56, 128, 128, {VGG: 1}),
    ("n6 fast", 28 * 28, 128, 192, {VGG: 1}),
    ("n6 slow", 28 * 28, 128, 64, {VGG: 1}),
    ("n7/n8", 28 * 28, 256, 256, {VGG: 2}),
    ("inception n5 fast", 37 * 37, 80, 160, {INC: 1}),
    ("inception n5 slow", 37 * 37, 80, 32, {INC: 1}),
    ("ragged", 37, 40, 136, {}),
    ("ragged P=1", 1, 32, 200, {}),
]

#: (label, H, KV, hd, S, pos, window, launches per request): b8.attn is a
#: kv-block split, positions [0, 3072) on the fast group, the rest on the
#: slow one; each side attends its whole block
ATTN_CASES = [
    ("b8.attn fast", 32, 32, 112, 3072, 3071, 0, {ZAMBA: 1}),
    ("b8.attn slow", 32, 32, 112, 1024, 1023, 0, {ZAMBA: 1}),
    ("b8.attn unsplit", 32, 32, 112, 4096, 4095, 0, {}),
    ("GQA g=4 hd=128", 32, 8, 128, 32768, 32767, 0, {}),
    ("window 1024", 32, 8, 128, 8192, 5000, 1024, {}),
    ("ragged S=1000", 16, 4, 64, 1000, 999, 0, {}),
]

#: (label, B, T, H, hd, N, launches per request); T = 16 is the port's
#: DECODE_T_MAX, the longest scan the decode kernel takes
SSD_CASES = [
    ("b*.ssm decode", 1, 1, 112, 64, 64, {ZAMBA: 8}),
    ("decode T=16", 1, 16, 112, 64, 64, {}),
    ("prefill T=4096", 1, 4096, 112, 64, 64, {}),
    ("ragged T=100", 2, 100, 6, 32, 16, {}),
]

_TIMES = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of one call (`repro_torch.runtime.autotune.
    time_ms`, which the autotuner measures with too): before each timed
    call a 128 MB write evicts the 50 MB L2 cache and a spin kernel holds
    the stream until the call and its end event are queued, so CUDA events
    bracket the call's device work and not the host's launch overhead."""
    from repro_torch.runtime.autotune import time_ms as device_time_ms
    return device_time_ms(fn, reps)


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


class Tally:
    """One kernel's numbers: max errors, and times summed over the
    launches of one request of each walk that holds its cases (float32),
    keyed by that walk's times key."""

    def __init__(self, library: bool = True):
        self.library = library
        self.max_abs_err = self.max_abs_err_bf16 = 0.0
        self.by_path: dict = {}

    def add(self, dtype, err: float, per_path: dict, times: dict) -> None:
        if dtype == torch.bfloat16:
            self.max_abs_err_bf16 = max(self.max_abs_err_bf16, err)
            return
        if per_path:
            self.max_abs_err = max(self.max_abs_err, err)
        for path, n in per_path.items():
            agg = self.by_path.setdefault(path, dict.fromkeys(_TIMES, 0.0))
            for key in _TIMES:
                if times.get(key) is not None:
                    agg[key] += times[key] * n

    def total(self, key: str, paths):
        """`key` summed over one request of each of `paths`."""
        if key == "library_ms" and not self.library:
            return None
        return sum(p[key] for name, p in self.by_path.items()
                   if name in paths)


def _report(kernel: str, label: str, dtype, err: float, times: dict,
            shape: str) -> None:
    lib = times.get("library_ms")
    print(f"{kernel} {label:20s} {str(dtype)[6:]:8s} {shape}: max_abs_err "
          f"{err:.3e} kernel {times['ms']:.4f} ms plain "
          f"{times['plain_ms']:.4f} ms library "
          f"{'none' if lib is None else f'{lib:.4f} ms'} bound "
          f"{times['bound_ms']:.4f} ms ({times['bound_ms'] / times['ms']:.1%}"
          f" of it)", flush=True)


def _times(kernel_fn, plain_fn, library_fn, n_bytes, ops, dtype, peaks):
    bnd, tb, to = bound_ms(n_bytes, ops, dtype, peaks)
    return {"ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
            "library_ms": None if library_fn is None else time_ms(library_fn),
            "bound_ms": bnd, "t_bytes": tb, "t_ops": to}


# Each `hold_*` takes one call's arguments, in its wrapper's order (the
# launch last, where the call names one), on the card: it holds the kernel against its plain version, times kernel, plain
# and library call beside the bound, prints the case and returns
# (max_abs_err, times).  The kernel phases give them seeded tensors at the
# shapes of `*_CASES`; `hold_walk_calls` gives them the calls a walk made.

def hold_split_matmul(label: str, args: tuple, peaks: dict):
    from repro_torch.kernels.split_matmul.split_matmul import (
        plan_call, split_matmul, split_matmul_plain)
    x, w, c0, width, *rest = args
    launch = rest[0] if rest else None
    (m, k), n, dtype = x.shape, w.shape[1], x.dtype
    got = split_matmul(x, w, c0, width, launch=launch)
    err = check(f"split_matmul {label} {dtype}", got,
                split_matmul_plain(x, w, c0, width), KERNEL_RTOL[dtype])
    if not torch.equal(got, split_matmul(x, w, c0, width, launch=launch)):
        raise AssertionError(f"split_matmul {label} {dtype}: two calls on "
                             f"the same inputs differ")
    plan = plan_call(x, w, c0, width, launch)
    times = _times(lambda: split_matmul(x, w, c0, width, launch=launch),
                   lambda: split_matmul_plain(x, w, c0, width),
                   lambda: torch.matmul(x, w[:, c0:c0 + width]),
                   x.element_size() * (m * k + k * width + m * width),
                   2 * m * k * width, dtype, peaks)
    _report("split_matmul", label, dtype, err, times,
            f"M={m} K={k} N={n} c0={c0} width={width} [variant "
            f"{plan.variant} {plan.col_tiles}x{plan.splits} blocks, k_chunk "
            f"{plan.k_chunk}]")
    return err, times


def hold_hadamard_matmul(label: str, args: tuple, peaks: dict):
    from repro_torch.kernels import build
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul, hadamard_matmul_plain, plan_hadamard)
    u, v, *rest = args
    launch = rest[0] if rest else None
    (g, p, k), n, dtype = u.shape, v.shape[2], u.dtype
    got = hadamard_matmul(u, v, launch=launch)
    err = check(f"hadamard_matmul {label} {dtype}", got,
                hadamard_matmul_plain(u, v), KERNEL_RTOL[dtype])
    plan = plan_hadamard(g, p, k, n, u.element_size(),
                         (u.data_ptr(), v.data_ptr(), got.data_ptr()),
                         build.sm_count(0), launch)
    times = _times(lambda: hadamard_matmul(u, v, launch=launch),
                   lambda: hadamard_matmul_plain(u, v),
                   lambda: torch.bmm(u, v),
                   u.element_size() * g * (p * k + k * n + p * n),
                   2 * g * p * k * n, dtype, peaks)
    _report("hadamard_matmul", label, dtype, err, times,
            f"P={p} K={k} N={n} [{plan.bm}x{plan.bn} tile, {plan.blocks} "
            f"blocks, vec {int(plan.vec)}]")
    return err, times


def hold_decode_attention(label: str, args: tuple, peaks: dict):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_attention_plain, plan_call, valid_range)
    q, k, v, pos, window, *rest = args
    launch = rest[0] if rest else None
    (h, hd), (s, kv, _), dtype = q.shape, k.shape, q.dtype
    out, lse = decode_attention(q, k, v, pos, window=window, launch=launch)
    want, want_lse = decode_attention_plain(q, k, v, pos, window=window)
    err = check(f"decode_attention {label} {dtype}", out, want,
                KERNEL_RTOL[dtype])
    check(f"decode_attention {label} {dtype} lse", lse, want_lse,
          KERNEL_RTOL[torch.float32])                # fp32 sums in both
    again = decode_attention(q, k, v, pos, window=window, launch=launch)
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"decode_attention {label} {dtype}: two calls "
                             f"on the same inputs differ")
    plan = plan_call(q, k, v, pos, window, launch)
    lo, hi = valid_range(s, pos, window)
    n = hi - lo + 1
    # the library call: the attended positions, (1, heads, S, hd)
    q4 = q[None, :, None, :]
    k4 = k[lo:hi + 1].permute(1, 0, 2)[None]
    v4 = v[lo:hi + 1].permute(1, 0, 2)[None]
    times = _times(
        lambda: decode_attention(q, k, v, pos, window=window, launch=launch),
        lambda: decode_attention_plain(q, k, v, pos, window=window),
        lambda: sdpa(q4, k4, v4, enable_gqa=h != kv),
        q.element_size() * (2 * h * hd + 2 * n * kv * hd) + 4 * h,
        4 * h * n * hd, dtype, peaks)
    _report("decode_attention", label, dtype, err, times,
            f"H={h} KV={kv} hd={hd} S={s} pos={pos} window={window} "
            f"[variant {plan.variant}, {plan.nsplit} runs of "
            f"{plan.run_len} over {lo}..{hi}, tile {plan.tile}, "
            f"{plan.stages} stages, {plan.blocks} blocks]")
    return err, times


def hold_ssd_chunk_scan(label: str, args: tuple, peaks: dict):
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        CHUNK, plan_call, ssd_chunk_scan, ssd_chunk_scan_plain)
    args, launch = args[:6], (args[6] if len(args) > 6 else None)
    x = args[0]
    (b, t, h, hd), n, dtype = x.shape, args[1].shape[2], x.dtype
    chunk = None if launch is None else launch.get("chunk")
    sf, y = ssd_chunk_scan(*args, launch=launch)
    sf_p, y_p = ssd_chunk_scan_plain(*args, chunk=chunk or CHUNK)
    err = max(check(f"ssd_chunk_scan {label} {dtype} y", y, y_p,
                    KERNEL_RTOL[dtype]),
              check(f"ssd_chunk_scan {label} {dtype} state", sf, sf_p,
                    KERNEL_RTOL[dtype]))
    plan = plan_call(*args, sf, launch)
    times = _times(lambda: ssd_chunk_scan(*args, launch=launch),
                   lambda: ssd_chunk_scan_plain(*args, chunk=chunk or CHUNK),
                   None,
                   nbytes(*args, y, sf), 6 * b * t * h * hd * n, dtype,
                   peaks)
    _report("ssd_chunk_scan", label, dtype, err, times,
            f"B={b} T={t} H={h} hd={hd} N={n} [variant {plan.variant}, "
            f"{plan.blocks} blocks of {plan.rows} rows, {plan.lanes} lanes "
            f"per row, chunk {plan.chunk}]")
    return err, times


HOLDS = {"split_matmul": hold_split_matmul,
         "hadamard_matmul": hold_hadamard_matmul,
         "decode_attention": hold_decode_attention,
         "ssd_chunk_scan": hold_ssd_chunk_scan}

DTYPES = (torch.float32, torch.bfloat16)


def split_matmul_phase(peaks: dict) -> Tally:
    gen = torch.Generator(device="cuda").manual_seed(11)
    tally = Tally()
    for label, m, k, n, c0, width, per_path in SPLIT_CASES:
        for dtype in DTYPES:
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            err, times = hold_split_matmul(label, (x, w, c0, width), peaks)
            tally.add(dtype, err, per_path, times)
    return tally


def hadamard_phase(peaks: dict) -> Tally:
    gen = torch.Generator(device="cuda").manual_seed(12)
    tally = Tally()
    for label, p, k, n, per_path in HADAMARD_CASES:
        for dtype in DTYPES:
            u = torch.randn((16, p, k), generator=gen, device="cuda").to(dtype)
            v = (torch.randn((16, k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            err, times = hold_hadamard_matmul(label, (u, v), peaks)
            tally.add(dtype, err, per_path, times)
    return tally


def decode_attention_phase(peaks: dict) -> Tally:
    gen = torch.Generator(device="cuda").manual_seed(13)
    tally = Tally()
    for label, h, kv, hd, s, pos, window, per_path in ATTN_CASES:
        for dtype in DTYPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for shape in ((h, hd), (s, kv, hd),
                                                (s, kv, hd)))
            err, times = hold_decode_attention(label, (q, k, v, pos, window),
                                               peaks)
            tally.add(dtype, err, per_path, times)
    return tally


def ssd_phase(peaks: dict) -> Tally:
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        CHUNK, CHUNKED, DECODE_T_MAX, SsdPlan, launch_uncounted, smem_bytes,
        ssd_chunk_scan_plain)
    if DECODE_T_MAX not in {case[2] for case in SSD_CASES}:
        raise AssertionError(f"SSD_CASES has no case at DECODE_T_MAX = "
                             f"{DECODE_T_MAX}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    tally = Tally(library=False)          # no one PyTorch call computes it
    floor = time_ms(lambda: torch.cuda._sleep(0))
    print(f"ssd_chunk_scan floor: time_ms of an empty kernel "
          f"(torch.cuda._sleep(0)) {floor:.4f} ms", flush=True)
    for label, b, t, h, hd, n, per_path in SSD_CASES:
        for dtype in DTYPES:
            def rand(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            # the ssm lowering's operands: stabilized dt and a, fan-in
            # scaled B, C and state
            ins = [u.to(dtype) for u in (
                rand(b, t, h, hd), rand(b, t, n) / n ** 0.5,
                rand(b, t, n) / n ** 0.5,
                0.05 + 0.2 * torch.sigmoid(rand(b, t, h)),
                -(0.1 + rand(h).abs()), rand(b, h, hd, n) / n ** 0.5)]
            err, times = hold_ssd_chunk_scan(label, tuple(ins), peaks)
            tally.add(dtype, err, per_path, times)
            if t <= DECODE_T_MAX and dtype == torch.float32:
                # the chunk kernel on the same inputs, launched directly
                # (not counted), against the decode kernel's time
                sf_p, y_p = ssd_chunk_scan_plain(*ins)
                length = min(CHUNK, t)
                chunked = SsdPlan(CHUNKED, 0, hd, b * h, length,
                                  smem_bytes(hd, n, length))
                y_c, sf_c = torch.empty_like(y_p), torch.empty_like(sf_p)
                launch_uncounted(chunked, ins, y_c, sf_c)
                check(f"ssd_chunk_scan {label} chunk kernel y", y_c, y_p,
                      KERNEL_RTOL[dtype])
                check(f"ssd_chunk_scan {label} chunk kernel state", sf_c,
                      sf_p, KERNEL_RTOL[dtype])
                ms_c = time_ms(lambda: launch_uncounted(chunked, ins, y_c,
                                                        sf_c))
                print(f"ssd_chunk_scan {label} T={t}: decode kernel "
                      f"{times['ms']:.4f} ms, chunk kernel {ms_c:.4f} ms, "
                      f"empty kernel {floor:.4f} ms, bound "
                      f"{times['bound_ms']:.4f} ms", flush=True)
    return tally


def _copy_aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` on its device at an address of the same
    alignment modulo 256 bytes (the kernels pick their vector variants
    from it)."""
    pad = t.data_ptr() % 256 // t.element_size()
    out = torch.empty(pad + t.numel(), dtype=t.dtype,
                      device=t.device)[pad:].view(t.shape)
    return out.copy_(t)


def kernel_calls(exe, x) -> dict:
    """Every kernel call one request of `exe`'s per-node walk makes on
    `x`, by kernel: {signature: [calls, arguments]}.  A profile hook sees
    each wrapper's call as it is made; a signature is the arguments'
    shapes, dtypes, scalars and each tensor's address modulo 16 bytes, and
    the first call of each keeps its arguments, copied on the caller's
    stream (`_copy_aligned`), for `hold_walk_calls`.  The request is not
    one a launch count is read from."""
    import inspect
    wrappers = kernel_counters()
    codes = {fn.__code__: (name, list(inspect.signature(fn).parameters))
             for name, fn in wrappers.items()}
    calls = {name: {} for name in wrappers}

    def hook(frame, event, _arg):
        if event != "call" or frame.f_code not in codes:
            return
        name, params = codes[frame.f_code]
        args = tuple(frame.f_locals[p] for p in params)
        sig = tuple((tuple(a.shape), a.dtype, a.data_ptr() % 16)
                    if torch.is_tensor(a) else a for a in args)
        entry = calls[name].setdefault(sig, [0, None])
        entry[0] += 1
        if entry[1] is None:
            entry[1] = tuple(_copy_aligned(a) if torch.is_tensor(a) else a
                             for a in args)

    sys.setprofile(hook)
    try:
        exe.run(x)
    finally:
        sys.setprofile(None)
    if exe.device.type == "cuda":
        torch.cuda.synchronize()
    return calls


def hold_walk_calls(label: str, calls: dict, want: dict, peaks: dict,
                    tallies: dict) -> None:
    """Hold each distinct kernel call of one request of a walk
    (`kernel_calls`) against its plain version in float32 and bfloat16,
    as the kernel phases hold their cases, and add it to its kernel's
    tally under `label` with its calls per request; those calls must add
    up to the plan's counts `want`."""
    for name, sigs in calls.items():
        made = sum(n for n, _ in sigs.values())
        if made != want[name]:
            raise AssertionError(f"{label}: the walk called {name} {made} "
                                 f"times, the plan gives {want[name]}")
        for i, (n, args) in enumerate(sigs.values()):
            for dtype in DTYPES:
                cast = tuple(a.to(dtype) if torch.is_tensor(a)
                             and a.is_floating_point() else a for a in args)
                err, times = HOLDS[name](f"{label} #{i} x{n}", cast, peaks)
                tallies[name].add(dtype, err, {label: n}, times)


def kernel_counters() -> dict:
    from repro_torch.runtime.segments import launch_counters
    return launch_counters()


def expected_counts(plan) -> dict:
    """Kernel launches, reshard points and elided gathers of one request
    of a plan's chained walk on two groups, from its specs and graph: a
    co-executed node launches its kernel once per group, an exclusive one
    once (convs launch `hadamard_matmul` when Winograd-eligible); a channel
    or stackable typed split's output is gathered once unless its sole
    consumer chains it, and a non-stackable one (kv-block) merges its
    sides itself."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.winograd_conv.ops import winograd_eligible
    kernel = {"linear": "split_matmul", "attention": "decode_attention",
              "ssm": "ssd_chunk_scan"}
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    specs = plan.exec_specs()
    for s in specs:
        if s.unit == "conv" and winograd_eligible(s.op):
            counts["hadamard_matmul"] += 2 if s.coexec else 1
        elif s.unit in kernel:
            counts[kernel[s.unit]] += 2 if s.coexec else 1
    coexec = {s.node_id for s in specs if s.coexec}
    merged = {s.node_id for s in specs if s.coexec and s.axis != "channel"
              and not registry.axis_spec(s.unit, s.axis).stackable}
    elided = plan.graph_ir().elided(coexec) - merged
    counts["reshard"] = len(coexec - merged - elided)
    counts["elided"] = len(elided)
    return counts


def fused_reshard_counts(plan) -> tuple:
    """(reshard points, elided gathers) of one request of the fused walk.
    Its segments are cut over the channel splits alone, and a typed-axis
    split runs as a singleton that gathers or merges its own sides, so the
    counts are the graph's materialization points and elided edges over
    the channel splits: the per-node walk's unless a head or ssm-state
    split chains with its neighbours there."""
    coexec = plan.coexec_node_ids()
    graph = plan.graph_ir()
    return (len(graph.materialization_points(coexec)),
            len(graph.elided(coexec)))


def _node_kind(spec) -> str:
    from repro_torch.kernels.winograd_conv.ops import winograd_eligible
    if spec.unit == "conv":
        return "winograd conv" if winograd_eligible(spec.op) else \
            "direct conv"
    if spec.op is None:
        return spec.unit
    return f"{spec.unit} ({spec.axis + ' split' if spec.coexec else 'one group'})"


def host_cpu_model() -> str:
    """The host CPU as `lscpu` names it (model name, vendor, CPU count),
    with /proc/cpuinfo's model name where `lscpu` knows none."""
    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError:
        out = ""
    for line in out.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip().lower(), value.strip())
    model = fields.get("model name", "unknown")
    if model in ("", "-", "unknown"):
        info = Path("/proc/cpuinfo")
        for line in (info.read_text().splitlines() if info.exists() else []):
            key, _, value = line.partition(":")
            if key.strip() == "model name":
                model = f"{value.strip()} (/proc/cpuinfo; lscpu: {model})"
                break
    return (f"{model}, vendor {fields.get('vendor id', 'unknown')}, "
            f"{fields.get('cpu(s)', '?')} CPUs")


def predictor_files(root: Path) -> dict:
    """Each predictor pickle under `root` with its modification time: a
    compile that trains writes its files, one that loads leaves them."""
    return {p.name: p.stat().st_mtime_ns for p in root.glob("*.pkl")}


def compile_phase(paths) -> dict:
    """Compile every main path with `repro_torch.compile` on this host,
    for its committed artifact's `Target` and mode, into a fresh plan
    cache and a fresh predictor cache; each document must equal the
    committed artifact's, checksum included, and a second compile must be
    a warm hit of the plan cache.  Returns the compiled networks by path
    name."""
    import repro_torch
    from repro_torch.graph.frontends import from_model

    print(f"compile: host {host_cpu_model()}; numpy {np.__version__}",
          flush=True)
    compiled = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_compile_") as tmp:
        plans, predictors = Path(tmp, "plans"), Path(tmp, "predictors")
        for name, artifact, _, _ in paths:
            doc = json.loads(artifact.read_text())
            target = repro_torch.Target.from_json(doc["target"])
            network = (from_model(ZAMBA, **ZAMBA_GRAPH) if name == ZAMBA
                       else name)
            before = predictor_files(predictors)
            t = time.perf_counter()
            net = repro_torch.compile(network, target, mode=doc["mode"],
                                      cache=plans,
                                      predictor_cache=predictors)
            cold = time.perf_counter() - t
            after = predictor_files(predictors)
            written = sorted(p for p in after if before.get(p) != after[p])
            if net.from_cache:
                raise AssertionError(f"compile {name}: the first compile "
                                     f"hit a fresh plan cache")
            got = net.to_json()
            if got != doc:
                raise AssertionError(
                    f"compile {name}: the port's plan differs from "
                    f"{artifact.name} (checksum {got['checksum']}, "
                    f"committed {doc['checksum']}; key {net.key}, "
                    f"committed {doc['plan']['provenance']})")
            t = time.perf_counter()
            again = repro_torch.compile(network, target, mode=doc["mode"],
                                        cache=plans,
                                        predictor_cache=predictors)
            warm = time.perf_counter() - t
            if not again.from_cache or again.to_json() != doc:
                raise AssertionError(f"compile {name}: the second compile "
                                     f"was not a warm hit of the plan")
            how = (f"predictors trained ({len(written)} files written)"
                   if written else
                   "predictors loaded (no file written)")
            print(f"compile {name}: threads {target.threads}, {how}; cold "
                  f"{cold:.3f} s, warm {warm:.3f} s; equal to "
                  f"{artifact.name} (checksum {got['checksum']}, key "
                  f"{net.key})", flush=True)
            compiled[name] = net
    return compiled


def main_path(name: str, compiled, make_input, out_shape, requests: int,
              rtol: float):
    """One main path: the network the port compiled, on two CUDA-stream
    groups, `requests` seeded inputs, each held against run_oracle within
    `rtol` of its largest |value|, launch counts checked per request
    against its plan; returns the launch counts (counters set to 0 just
    before the path, read just after), its float32 executor, the expected
    counts and each request's (input, output, oracle)."""
    from repro_torch.analysis import errors, verify_plan

    t0 = time.perf_counter()
    bad = errors(verify_plan(compiled.plan, stats=False))
    if bad:
        raise AssertionError(f"{name}: the compiled plan fails the static "
                             f"verifier: {bad[0]}")
    exe = compiled.executor(device="cuda")
    want = expected_counts(compiled.plan)
    print(f"{name}: the plan (key {compiled.key}), weights "
          f"on {exe.device} in {time.perf_counter() - t0:.1f} s; groups "
          f"{len(exe.groups)}; per request the plan gives {want}",
          flush=True)
    if not exe.split_capable:
        raise AssertionError("the main path needs two co-execution groups")
    exe.run(warmup=True)                       # builds, cuDNN choice

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    per_run, outputs = [], []
    for r in range(requests):
        x = make_input(r)
        before = {k: fn.launches for k, fn in counters.items()}
        t = time.perf_counter()
        y, rep = exe.run(x)
        wall = (time.perf_counter() - t) * 1e3
        per_run.append({k: fn.launches - before[k]
                        for k, fn in counters.items()})
        outputs.append((x, y, rep, wall))
    counts = {k: fn.launches for k, fn in counters.items()}

    refs = []
    for r, ((x, y, rep, wall), launched) in enumerate(zip(outputs, per_run)):
        oracle = exe.run_oracle(x)
        refs.append((x, y, oracle))
        torch.cuda.synchronize()
        if tuple(y.shape) != out_shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name} request {r}: output "
                                 f"{tuple(y.shape)} is not a finite "
                                 f"{out_shape} tensor")
        err = float((y - oracle).abs().max())
        scale = max(1.0, float(oracle.abs().max()))
        if err > rtol * scale:
            raise AssertionError(f"{name} request {r}: max |run - "
                                 f"run_oracle| = {err:.3e} > "
                                 f"{rtol} x {scale:.3g}")
        for k in KERNEL_NAMES:
            if launched[k] != want[k]:
                raise AssertionError(f"{name} request {r}: {launched[k]} "
                                     f"{k} launches, want {want[k]}")
        if (rep.reshard_points, rep.elided) != (want["reshard"],
                                                want["elided"]):
            raise AssertionError(
                f"{name} request {r}: {rep.reshard_points} reshard points, "
                f"{rep.elided} elided; want {want['reshard']} and "
                f"{want['elided']}")
        share = {}
        for t, spec in zip(rep.timings, exe.specs):
            kind = _node_kind(spec)
            share[kind] = share.get(kind, 0.0) + t.wall_us
        parts = ", ".join(f"{k} {v / rep.wall_us:.1%}"
                          for k, v in sorted(share.items()))
        shown = " ".join(f"{k} {launched[k]}" for k in KERNEL_NAMES
                         if want[k])
        print(f"{name} request {r}: wall {wall:.3f} ms (nodes "
              f"{rep.wall_us / 1e3:.3f} ms: {parts}); max_abs_err "
              f"{err:.3e} (scale {scale:.3g}); launches {shown}; reshard "
              f"{rep.reshard_points} elided {rep.elided} syncs "
              f"{rep.sync_points}", flush=True)
    walls = sorted(o[3] for o in outputs)
    print(f"{name}: median request wall {statistics.median(walls):.3f} ms "
          f"over {requests} requests (min {walls[0]:.3f}, max "
          f"{walls[-1]:.3f})", flush=True)
    return counts, exe, want, refs


def fused_path(name: str, exe, want: dict, refs: list,
               rtol: float) -> dict:
    """The fused segment walk of a main path: capture every fused segment
    as a CUDA graph, then run the per-node walk's requests again, each
    output bit-identical to that walk's and within `rtol` of run_oracle,
    with the same launch counts, the reshard and elided counts of
    `fused_reshard_counts` and one sync per segment; returns the launch
    counts (counters set to 0 just before the requests, read just
    after)."""
    from repro_torch.graph.ir import SEGMENT_FUSED

    reshard, elided = fused_reshard_counts(exe.plan)
    partition = exe.plan.segment_partition()
    specs = {s.node_id: s for s in exe.specs}
    t = time.perf_counter()
    programs = exe.segment_programs()          # the requests' input shape
    torch.cuda.synchronize()
    captured = sum(p.graph is not None for p in programs)
    n_fused = sum(s.kind == SEGMENT_FUSED for s in partition)
    print(f"{name} fused: {len(programs)} segments, {n_fused} fused; "
          f"captured {captured} CUDA graphs in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if captured != n_fused:
        raise AssertionError(f"{name}: {captured} graphs for {n_fused} "
                             f"fused segments")
    for p in programs:
        held = (", ".join(f"{k} {n}" for k, n in p.launches.items())
                or "no launch of the port's kernels")
        what = (f"graph holds {held}" if p.graph is not None
                else f"eager ({p.modes[p.node_ids[0]]})")
        print(f"  segment {p.index:2d} {p.kind:9s} "
              f"{' + '.join(p.node_ids)}: {what}", flush=True)
    exe.run(refs[0][0], fused=True, warmup=True)     # warm the replays

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = []
    for x, _, _ in refs:
        before = {k: fn.launches for k, fn in counters.items()}
        t = time.perf_counter()
        y, rep = exe.run(x, fused=True)
        wall = (time.perf_counter() - t) * 1e3
        runs.append((y, rep, wall, {k: fn.launches - before[k]
                                    for k, fn in counters.items()}))
    counts = {k: fn.launches for k, fn in counters.items()}

    for r, ((x, y_node, oracle), (y, rep, wall, launched)) in enumerate(
            zip(refs, runs)):
        if not torch.equal(y, y_node):
            diff = float((y - y_node).abs().max())
            raise AssertionError(f"{name} fused request {r}: output differs "
                                 f"from the per-node walk's (max |diff| "
                                 f"{diff:.3e})")
        err = float((y - oracle).abs().max())
        scale = max(1.0, float(oracle.abs().max()))
        if not err <= rtol * scale:
            raise AssertionError(f"{name} fused request {r}: max |run - "
                                 f"run_oracle| = {err:.3e} > "
                                 f"{rtol} x {scale:.3g}")
        for k in KERNEL_NAMES:
            if launched[k] != want[k]:
                raise AssertionError(f"{name} fused request {r}: "
                                     f"{launched[k]} {k} launches, want "
                                     f"{want[k]}")
        if (rep.reshard_points, rep.elided) != (reshard, elided):
            raise AssertionError(
                f"{name} fused request {r}: {rep.reshard_points} reshard "
                f"points, {rep.elided} elided; want {reshard} and {elided}")
        if not rep.fused or rep.sync_points != len(partition):
            raise AssertionError(f"{name} fused request {r}: "
                                 f"{rep.sync_points} syncs, want one per "
                                 f"segment ({len(partition)})")
        share = {}
        for seg_wall, p in zip(rep.segment_wall_us, programs):
            kind = ("graph replays" if p.graph is not None else
                    _node_kind(specs[p.node_ids[0]]))
            share[kind] = share.get(kind, 0.0) + seg_wall
        parts = ", ".join(f"{k} {v / rep.wall_us:.1%}"
                          for k, v in sorted(share.items()))
        shown = " ".join(f"{k} {launched[k]}" for k in KERNEL_NAMES
                         if want[k])
        print(f"{name} fused request {r}: wall {wall:.3f} ms (segments "
              f"{rep.wall_us / 1e3:.3f} ms: {parts}); bit-identical to the "
              f"per-node walk; max_abs_err {err:.3e} (scale {scale:.3g}); "
              f"launches {shown}; reshard {rep.reshard_points} elided "
              f"{rep.elided} syncs {rep.sync_points}", flush=True)
    return counts


def alternating_walls(exes: dict, x, pairs: int) -> None:
    """Request walls of the per-node and fused walks of one or more plans'
    executors (`exes`, by label) on one input, run in turns (per-node,
    fused, then the next plan's, ...), so all see the same card and host
    state."""
    walls = {}
    for _ in range(pairs):
        for label, exe in exes.items():
            for fused in (False, True):
                t = time.perf_counter()
                exe.run(x, fused=fused)
                walls.setdefault((label, fused), []).append(
                    (time.perf_counter() - t) * 1e3)
    parts = []
    for (label, fused), ms in walls.items():
        ms = sorted(ms)
        walk = "fused" if fused else "per-node"
        parts.append(f"{label} {walk} median "
                     f"{statistics.median(ms):.3f} ms (min {ms[0]:.3f}, max "
                     f"{ms[-1]:.3f})")
    print(f"walls, {pairs} alternating rounds: " + "; ".join(parts),
          flush=True)


def bf16_path(name: str, compiled, want: dict, refs: list) -> dict:
    """The path in bfloat16 (`executor(dtype="bfloat16")`): the first
    `BF16_REQUESTS` requests of the float32 path, per-node then fused, each
    output a finite bf16 tensor within `BF16_RTOL` of the float32
    run_oracle, the fused outputs `torch.equal` to the per-node ones, with
    the float32 path's launch counts; returns the launch counts per walk
    (counters set to 0 just before each walk's requests, read just
    after)."""
    t = time.perf_counter()
    exe = compiled.executor(device="cuda", dtype="bfloat16")
    x0 = refs[0][0]
    exe.run(x0, warmup=True)                   # bf16 builds, cuDNN choice
    exe.run(x0, fused=True, warmup=True)       # bf16 captures
    print(f"{name} bf16: weights and graphs in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    counters = kernel_counters()
    counts, per_node = {}, []
    for fused in (False, True):
        walk = f"{name} bf16{' fused' if fused else ''}"
        for fn in counters.values():
            fn.launches = 0
        for r, (x, _, oracle) in enumerate(refs[:BF16_REQUESTS]):
            before = {k: fn.launches for k, fn in counters.items()}
            y, rep = exe.run(x, fused=fused)
            torch.cuda.synchronize()
            launched = {k: fn.launches - before[k]
                        for k, fn in counters.items()}
            if (y.dtype != torch.bfloat16 or y.shape != oracle.shape
                    or not bool(torch.isfinite(y).all())):
                raise AssertionError(f"{walk} request {r}: output "
                                     f"{tuple(y.shape)} {y.dtype} is not a "
                                     f"finite bf16 {tuple(oracle.shape)}")
            err = float((y.float() - oracle).abs().max())
            scale = max(1.0, float(oracle.abs().max()))
            if not err <= BF16_RTOL * scale:
                raise AssertionError(f"{walk} request {r}: max |run - fp32 "
                                     f"run_oracle| = {err:.3e} > "
                                     f"{BF16_RTOL} x {scale:.3g}")
            if fused and not torch.equal(y, per_node[r]):
                raise AssertionError(f"{walk} request {r}: output differs "
                                     f"from the bf16 per-node walk's")
            if not fused:
                per_node.append(y.clone())
            for k in KERNEL_NAMES:
                if launched[k] != want[k]:
                    raise AssertionError(f"{walk} request {r}: "
                                         f"{launched[k]} {k} launches, "
                                         f"want {want[k]}")
            shown = " ".join(f"{k} {launched[k]}" for k in KERNEL_NAMES
                             if want[k])
            print(f"{walk} request {r}: max_abs_err vs the fp32 oracle "
                  f"{err:.3e} (scale {scale:.3g}, {err / scale:.2e} of it)"
                  f"{'; bit-identical to the per-node walk' if fused else ''}"
                  f"; launches {shown}; syncs {rep.sync_points}", flush=True)
        counts[walk] = {k: fn.launches for k, fn in counters.items()}
    return counts


def changed_nodes(old, new) -> list:
    """Each node whose decision moved its axis or its boundary between two
    plans, as "node axis cpu/gpu -> axis cpu/gpu"."""
    moved = []
    after = new.plan.decisions_by_node
    for nid, o in old.plan.decisions_by_node.items():
        n = after[nid]
        if (o.axis, o.c_cpu, o.c_gpu) != (n.axis, n.c_cpu, n.c_gpu):
            moved.append(f"{nid} {o.axis} {o.c_cpu}/{o.c_gpu} -> {n.axis} "
                         f"{n.c_cpu}/{n.c_gpu}")
    return moved


def calibrate_path(name: str, net: str, compiled, make_input, out_shape,
                   peaks: dict, tallies: dict):
    """The measurement loop on the card for a compiled network of `net`
    that carries the predictors it planned with: `RECORD_RUNS` per-node
    runs and one fused run recorded into a fresh store (each kernel
    launched 3x the plan's count), `recalibrate()` (the fidelity error
    over the card's records may not grow), `replan()` and its diff, the
    replanned plan saved and loaded back strictly, then run per node and
    fused against its own `run_oracle` and `expected_counts`, each kernel
    call of one of its requests held against the plain version
    (`hold_walk_calls`), and the two plans' walls in turns.  Returns the
    walks as {walk: (times key, launch counts)} and the replanned
    network."""
    from repro_torch.api import CompiledNetwork
    from repro_torch.measure import MeasurementStore, fidelity_error

    walks = {}
    exe = compiled.executor(device="cuda")
    want = expected_counts(compiled.plan)
    x = make_input(REQUESTS)
    # kernel builds and the fused segments' captures (whose warm-up runs
    # launch kernels) stay out of the records and the counted runs
    exe.run(x, warmup=True)
    exe.run(x, fused=True, warmup=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_calibrate_") as tmp:
        store = MeasurementStore(Path(tmp, "measurements"))
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        for fused in (False,) * RECORD_RUNS + (True,):
            rep = compiled.record(x, store=store, device="cuda",
                                  warmup=False, fused=fused)
            print(f"{name} record{' fused' if fused else ''}: "
                  f"{rep.fidelity_summary()}", flush=True)
        recorded = time.perf_counter() - t
        counts = {k: fn.launches for k, fn in counters.items()}
        walks[f"{name} calibrate"] = (None, counts)
        for k in KERNEL_NAMES:
            runs = RECORD_RUNS + 1
            if counts[k] != runs * want[k]:
                raise AssertionError(
                    f"{name} calibrate: {counts[k]} {k} launches over "
                    f"{runs} recorded runs, want {runs * want[k]}")
        records = store.load(compiled.key)
        cal = compiled.recalibrate(store)
        pre, post = fidelity_error(records), cal.fidelity_error(records)
        if not post <= pre:
            raise AssertionError(f"{name} calibrate: the fit raised the "
                                 f"fidelity error {pre} -> {post}")
        print(f"{name} calibrate: {len(records)} records ({cal.n_records} "
              f"usable) from {RECORD_RUNS} per-node runs and 1 fused run in "
              f"{recorded:.2f} s; fidelity error (sum |log wall/pred|) "
              f"{pre:.3f} -> {post:.3f} over the card's records; calibrator "
              f"{cal.version}", flush=True)
        for line in cal.summary().splitlines():
            print(f"  {line.strip()}", flush=True)
        t = time.perf_counter()
        new, diff = compiled.replan(cal, store=store,
                                    cache=Path(tmp, "plans"))
        replan_s = time.perf_counter() - t
        for line in diff.summary().splitlines():
            print(f"{name} {line.strip()}", flush=True)
        moved = changed_nodes(compiled, new)
        print(f"{name} replan: {replan_s:.3f} s on the host; nodes that "
              f"moved their axis or boundary: "
              f"{'; '.join(moved) if moved else 'none (an empty diff)'}",
              flush=True)
        loaded = CompiledNetwork.load(new.save(Path(tmp, "replanned.json")))
        if loaded.to_json() != new.to_json():
            raise AssertionError(f"{name} replan: the saved plan does not "
                                 f"load back as it was")
        print(f"{name} replanned: saved and loaded strictly (key "
              f"{loaded.key}, calibration {loaded.provenance.calibration})",
              flush=True)
    label = f"{name} replanned"
    counts, exe_new, want_new, refs = main_path(
        label, loaded, make_input, out_shape, REPLAN_REQUESTS, E2E_RTOL[net])
    walks[label] = (label, counts)
    walks[f"{label} fused"] = (label, fused_path(label, exe_new, want_new,
                                                 refs, E2E_RTOL[net]))
    hold_walk_calls(label, kernel_calls(exe_new, make_input(0)), want_new,
                    peaks, tallies)
    alternating_walls({f"{name} original": exe, label: exe_new}, x,
                      WALL_PAIRS)
    return walks, new


def portfolio_phase(peaks: dict, tallies: dict) -> dict:
    """The committed zamba2-7b portfolio: compiled on this host by
    `compile_portfolio` into fresh caches (its document equal to the
    committed one, checksum included; a second compile all warm hits);
    the file loaded strictly and each entry, picked by `select`, run on
    the card per node and fused against its `run_oracle` with its
    `expected_counts`, each kernel call of one of its requests held
    against the plain version; then the replan path of a server: the
    in-process portfolio's entry for the live step `PORTFOLIO_STEP`
    recorded, recalibrated and replanned (`calibrate_path`) and swapped in
    with `replace`, the bucket tag kept, the new document loaded back
    strictly.  Returns the walks as {walk: (times key, launch counts)}."""
    import repro_torch

    doc = json.loads(PORTFOLIO.read_text())
    target = repro_torch.Target.from_json(doc["target"])
    buckets = [(e["batch"], e["seq"]) for e in doc["entries"]]
    with tempfile.TemporaryDirectory(prefix="repro_torch_portfolio_") as tmp:
        kw = dict(buckets=buckets, blocks=ZAMBA_GRAPH["blocks"],
                  cache=Path(tmp, "plans"),
                  predictor_cache=Path(tmp, "predictors"))
        t = time.perf_counter()
        pf = repro_torch.compile_portfolio(doc["model"], target, **kw)
        cold = time.perf_counter() - t
        got = pf.to_json()
        if any(c.from_cache for c in pf.entries.values()) or got != doc:
            raise AssertionError(
                f"portfolio: the port's portfolio differs from "
                f"{PORTFOLIO.name} (checksum {got['checksum']}, committed "
                f"{doc['checksum']})")
        t = time.perf_counter()
        again = repro_torch.compile_portfolio(doc["model"], target, **kw)
        warm = time.perf_counter() - t
        if (not all(c.from_cache for c in again.entries.values())
                or again.to_json() != doc):
            raise AssertionError("portfolio: the second compile was not all "
                                 "warm hits of the committed document")
    print(f"portfolio {doc['model']}: buckets "
          f"{', '.join(b.tag for b in pf.buckets)}; cold {cold:.3f} s, warm "
          f"{warm:.3f} s; equal to {PORTFOLIO.name} (checksum "
          f"{got['checksum']}); keys "
          f"{', '.join(c.key for c in pf.entries.values())}", flush=True)
    walks = {}
    loaded = repro_torch.PlanPortfolio.load(PORTFOLIO)
    for b in loaded.buckets:
        picked, compiled = loaded.select(b.batch, b.seq)
        if picked != b:
            raise AssertionError(f"portfolio: select({b.batch}, {b.seq}) "
                                 f"picked {picked.tag}, not {b.tag}")
        label = f"{ZAMBA} {b.tag}"
        make = decode_input(b.batch)
        counts, exe, want, refs = main_path(
            label, compiled, make, (b.batch, ZAMBA_D), PORTFOLIO_REQUESTS,
            E2E_RTOL[ZAMBA])
        walks[label] = (label, counts)
        walks[f"{label} fused"] = (label, fused_path(label, exe, want, refs,
                                                     E2E_RTOL[ZAMBA]))
        hold_walk_calls(label, kernel_calls(exe, make(0)), want, peaks,
                        tallies)
        del compiled, exe, refs
        torch.cuda.empty_cache()

    if not pf.can_replan() or loaded.can_replan():
        raise AssertionError("portfolio: an in-process portfolio must be "
                             "able to replan and a loaded one must not")
    b, entry = pf.select(*PORTFOLIO_STEP)
    print(f"portfolio: the live step (batch, seq) = {PORTFOLIO_STEP} is "
          f"served by {b.tag}", flush=True)
    cal_walks, new = calibrate_path(
        f"{ZAMBA} {b.tag}", ZAMBA, entry, decode_input(b.batch),
        (b.batch, ZAMBA_D), peaks, tallies)
    walks.update(cal_walks)
    pf.replace(b, new)
    doc_new = pf.to_json()
    back = repro_torch.PlanPortfolio.from_json(doc_new)
    others_kept = all(e == o for e, o in zip(doc_new["entries"],
                                              doc["entries"])
                      if (o["batch"], o["seq"]) != (b.batch, b.seq))
    if (pf.select(*PORTFOLIO_STEP)[1] is not new
            or new.provenance.bucket != b.tag or not others_kept
            or back.entries[b].to_json() != new.to_json()):
        raise AssertionError(f"portfolio: {b.tag} was not replaced by its "
                             f"replanned plan")
    print(f"portfolio: {b.tag} replaced by its replanned plan (key "
          f"{new.key}, bucket tag {new.provenance.bucket}); checksum "
          f"{doc['checksum']} -> {doc_new['checksum']}, the new document "
          f"loads strictly", flush=True)
    return walks


# ------------------------------------------------------------------- serve

def _to_device(tree, device):
    """A model's params (nested dicts and lists of tensors) on `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def serve_reduced_check(cfg) -> None:
    """Reduced `cfg` in fp32: the same seeded weights on the CPU and on the
    card, a left-padded prefill then decode steps at a shared position
    and at per-row positions; every logit within `SERVE_LOGIT_RTOL` of the
    largest |CPU logit| (the CPU tests tie the CPU path to the
    reference's)."""
    from repro_torch.models import build_model
    small = dataclasses.replace(cfg.reduced(), dtype="float32")
    model = build_model(small)
    params = {"cpu": model.init(torch.Generator().manual_seed(0))}
    params["cuda"] = _to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(500)
    b, t = 3, 12
    toks = torch.from_numpy(rng.integers(1, small.vocab_size, (b, t)))
    steps = torch.from_numpy(rng.integers(1, small.vocab_size, (4, b, 1)))
    start = torch.tensor([0, 4, 7])
    logits = {}
    for dev in ("cpu", "cuda"):
        cache = model.init_cache(b, 32, device=dev)
        out, cache = model.prefill(params[dev], toks.to(dev), cache,
                                   start=start.to(dev))
        logits[dev] = [out]
        for i, tok in enumerate(steps):
            pos = (t + i if i < 2 else
                   torch.tensor([t + i, t + i + 2, t + i + 1], device=dev))
            out, cache = model.decode_step(params[dev], tok.to(dev), cache,
                                           pos, start=start.to(dev))
            logits[dev].append(out)
    worst = 0.0
    for i, (want, got) in enumerate(zip(logits["cpu"], logits["cuda"])):
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if not err <= SERVE_LOGIT_RTOL * scale:
            raise AssertionError(f"serve reduced: step {i} logits on the "
                                 f"card differ from the CPU's by {err:.3e} "
                                 f"> {SERVE_LOGIT_RTOL} x {scale:.3g}")
    print(f"serve reduced {small.name} (d_model {small.d_model}, "
          f"{small.n_layers} layers, fp32): prefill + 4 decode steps on the "
          f"card within {worst:.2e} of the CPU's largest |logit| (limit "
          f"{SERVE_LOGIT_RTOL:g})", flush=True)


def _first_divergence(model, params, req, got, want) -> str:
    """Where the scheduler's tokens for `req` leave the solo run's: the
    step, both tokens, and the top-2 logit gap of the solo run there."""
    step = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))
    cache = model.init_cache(1, SERVE_MAX_LEN, device="cuda")
    prompt = torch.from_numpy(req.prompt.astype(np.int64))[None].cuda()
    logits, cache = model.prefill(params, prompt, cache)
    for i in range(step):
        logits, cache = model.decode_step(
            params, torch.tensor([[want[i]]], device="cuda"), cache,
            len(req.prompt) + i)
    top = logits[0].float().topk(2).values
    return (f"request {req.rid} step {step}: scheduler "
            f"{got[step] if step < len(got) else None}, solo "
            f"{want[step] if step < len(want) else None}; the solo run's "
            f"top-2 logit gap there {float(top[0] - top[1]):.3e}")


def _profile(label: str, fn, n: int):
    """`n` calls of `fn` under torch.profiler: the CUDA kernels' rows
    (device ms per call, launches over the `n` calls, name) by falling
    device time, their device ms per call, the wall per call in ms (host
    clock around the calls and a sync), and per call the host calls that
    put work on the card (kernel launches, copies and graph launches: the
    CUDA runtime's API events in the trace), by name.  Raises if the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count, e.key)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0.0:
        raise AssertionError(f"profile {label}: the trace holds no device "
                             f"time")
    calls = {}
    for e in events:
        if e.key.startswith(HOST_LAUNCH_CALLS):
            calls[e.key] = calls.get(e.key, 0) + e.count / n
    return rows, busy, wall, calls


def decode_breakdown(label: str, model, params, batch: int,
                     steps: int = 4, top: int = 8) -> None:
    """Where a decode step's time goes: `steps` steps of `batch` slots at
    per-slot positions (the scheduler's call), timed bare (host clock
    around the steps and a sync), then under torch.profiler: device time
    by kernel against the step wall, and the host calls that put work on
    the card.  Raises if the trace holds no device time."""
    cache = model.init_cache(batch, SERVE_MAX_LEN, device="cuda")
    tok = torch.ones((batch, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(batch, device="cuda")

    def step():
        model.decode_step(params, tok, cache, pos)

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t) * 1e3 / steps
    rows, busy, wall, calls = _profile(label, step, steps)
    print(f"profile {label}: decode step of {batch} slots, wall {bare:.3f} "
          f"ms bare, {wall:.3f} ms under the profiler; kernels {busy:.3f} "
          f"ms of device time in {sum(r[1] for r in rows) / steps:g} "
          f"launches (idle >= {1 - busy / wall:.1%} of the profiled wall); "
          f"host launch calls per step {sum(calls.values()):g}", flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:8.3f} ms {count / steps:6g}x {key[:100]}", flush=True)


@contextlib.contextmanager
def executed_plans():
    """Every CompiledNetwork whose plan is executed inside the block, by
    plan key: each execution takes its executor from
    `CompiledNetwork.executor` (the scheduler's `profile` runs, its replan
    candidates', and `ServingEngine.execute_plan`)."""
    from repro_torch.api import CompiledNetwork

    seen = {}
    real = CompiledNetwork.executor

    def executor(self, **kw):
        seen.setdefault(self.key, self)
        return real(self, **kw)

    CompiledNetwork.executor = executor
    try:
        yield seen
    finally:
        CompiledNetwork.executor = real


def offered_load(label: str, traffic, rep) -> str:
    """The wall-clock run's offered load against what the card served:
    slot-steps (the scheduler prefills one prompt token a step, and the
    last prompt step emits the first token, so a request holds a slot
    prompt + new - 1 steps) per second of arrivals, against the slots
    over the run's mean step."""
    need = sum(len(r.prompt) + r.max_new_tokens - 1 for r in traffic)
    span = max(r.arrival_s for r in traffic)
    step = rep.duration_s / rep.steps
    capacity = SERVE_MAX_BATCH / step
    ratio = need / span / capacity
    verdict = (f"{ratio:.2f}x overloaded: its TTFT and latency measure a "
               f"backlog draining, not serving latency" if ratio > 1 else
               f"{ratio:.2f} of capacity")
    return (f"{label}: offered {need} slot-steps over {span:.4f} s of "
            f"arrivals ({need / span:.1f}/s); the card served at most "
            f"{capacity:.1f}/s ({SERVE_MAX_BATCH} slots / the run's mean "
            f"step {step * 1e3:.3f} ms, plan executions included): "
            f"{verdict}; TTFT includes each prompt's token-by-token prefill")


def _report_line(label: str, rep, host_s: float) -> str:
    return (f"{label}: {len(rep.stats)} requests, {rep.total_tokens} tokens "
            f"in {rep.steps} steps; {rep.clock} clock {rep.duration_s:.4f} "
            f"s, {rep.tokens_per_s:.1f} tok/s; TTFT p50 "
            f"{rep.ttft_p(50) * 1e3:.2f} ms, latency p50 "
            f"{rep.latency_p(50) * 1e3:.2f} ms p99 "
            f"{rep.latency_p(99) * 1e3:.2f} ms; bucket steps "
            f"{dict(sorted(rep.bucket_steps.items()))}, switches "
            f"{rep.bucket_switches}, replans {len(rep.replan_events)}; host "
            f"wall {host_s:.3f} s ({rep.total_tokens / host_s:.1f} tok/s)")


def serve_phase(peaks: dict, tallies: dict, smi: str) -> dict:
    """The serving path at codeqwen1.5-7b's published widths and full
    depth (`SERVE_ARCH`), its weights seeded draws made on the card:

    - a portfolio (`SERVE_BUCKETS`) compiled on this host, cold then warm;
      each entry's plan run as a main path is (`main_path`) and every
      kernel call of one of its requests held against its plain version
      (`hold_walk_calls`);
    - the reduced model on the card against the CPU (`serve_reduced_check`);
    - in fp32: `ContinuousScheduler` over `SERVE_TRAFFIC` greedy Poisson
      requests on the virtual clock, its plans executed every
      `SERVE_FIDELITY_EVERY` steps, each completion equal to the request
      served alone by the fixed-batch engine, token for token;
    - in bf16: the fixed-batch `ServingEngine` on `SERVE_FIXED_REQUESTS`
      requests shipping the b4 entry (`compiled=`, one `execute_plan`), and
      the scheduler again on the wall clock, whose tokens/s, TTFT and
      latency percentiles are printed beside the card's name and limit,
      with its offered load against the card's service (`offered_load`);
      then a profiled decode step at batch 1 and 4 (`decode_breakdown`);
    - the scheduler once more with a simulated throttle: at least one
      validated in-place replan must be committed;
    - every plan the runs above executed (`executed_plans`: replanned
      entries and rejected candidates alike, and the plan the engine
      shipped) that the entries did not hold: run and its kernel calls
      held as above.

    Returns the walks as {walk: (times key, launch counts)}: counters set
    to 0 just before each walk, read just after."""
    import repro_torch
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import (ContinuousScheduler,
                                     FixedBatchReference, Request,
                                     SchedulerConfig, ServingEngine,
                                     ThrottleSim, poisson_requests)

    # earlier phases' executors and CUDA graphs may sit in reference
    # cycles: collect them, so the peaks below are this phase's
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(SERVE_ARCH)
    name = cfg.name
    n = cfg.param_count()
    print(f"serve {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim} (kv {cfg.n_kv_heads}), "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n / 1e9:.3f} B "
          f"parameters ({2 * n / 1e9:.1f} GB bf16, {4 * n / 1e9:.1f} GB "
          f"fp32); {held:.1f} GB allocated on the card before the phase",
          flush=True)
    walks = {}
    counters = kernel_counters()

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_") as tmp:
        target = repro_torch.Target(device="moto2022")
        kw = dict(buckets=SERVE_BUCKETS, cache=Path(tmp, "plans"),
                  predictor_cache=Path(tmp, "predictors"))
        t = time.perf_counter()
        pf = repro_torch.compile_portfolio(cfg, target, **kw)
        cold = time.perf_counter() - t
        t = time.perf_counter()
        again = repro_torch.compile_portfolio(cfg, target, **kw)
        warm = time.perf_counter() - t
        if not all(c.from_cache for c in again.entries.values()):
            raise AssertionError("serve: the second portfolio compile was "
                                 "not all warm hits")
        print(f"serve portfolio {pf}: cold {cold:.3f} s, warm {warm:.3f} s; "
              f"checksum {pf.to_json()['checksum']}", flush=True)
        for b, c in pf.entries.items():
            splits = ", ".join(
                f"{nid} {d.axis} {d.c_cpu}/{d.c_gpu}"
                for nid, d in c.plan.decisions_by_node.items()
                if not d.exclusive)
            print(f"  {b.tag}: key {c.key}, end-to-end "
                  f"{c.plan.end_to_end_us / 1e3:.3f} ms on the simulated "
                  f"phone; splits: {splits or 'none'}", flush=True)
            label = f"{name} {b.tag}"
            make = decode_input(b.batch, cfg.d_model)
            counts, exe, _, _ = main_path(label, c, make,
                                          (b.batch, cfg.d_model),
                                          PORTFOLIO_REQUESTS, SERVE_E2E_RTOL)
            walks[label] = (label, counts)
            hold_walk_calls(label, kernel_calls(exe, make(0)),
                            expected_counts(c.plan), peaks, tallies)
        serve_reduced_check(cfg)

        largest = pf.entries[pf.buckets[-1]]
        cost = largest.plan.end_to_end_us * 1e-6
        traffic = poisson_requests(
            SERVE_TRAFFIC, rate=0.33 / cost, vocab_size=cfg.vocab_size,
            prompt_lens=(4, 8, 16), max_new=(4, 8, 12), temperatures=(0.0,),
            seed=19)
        fixed = FixedBatchReference(largest, max_batch=SERVE_MAX_BATCH)
        print(f"serve traffic: {SERVE_TRAFFIC} greedy Poisson requests at "
              f"{0.33 / cost:.2f} req/s (0.33 / the {pf.buckets[-1].tag} "
              f"plan's {cost * 1e3:.3f} ms); the fixed-batch reference on "
              f"that plan: {fixed.run(traffic).summary()}", flush=True)

        def scheduler(model, params, clock, store, throttle=None, **conf):
            conf = {"fidelity_every": SERVE_FIDELITY_EVERY, **conf}
            return ContinuousScheduler(
                cfg, model, params, portfolio=pf, device="cuda",
                measurement_store=Path(tmp, store),
                plan_cache=Path(tmp, "plans"), throttle=throttle,
                config=SchedulerConfig(max_batch=SERVE_MAX_BATCH,
                                       max_len=SERVE_MAX_LEN, clock=clock,
                                       **conf))

        # every plan the runs below execute: the scheduler's fidelity runs,
        # its replan candidates (committed or not) and the fixed batch's
        # execute_plan; the entries above are held already
        held = {c.key for c in pf.entries.values()}
        events = []
        with executed_plans() as executed:
            # fp32 (TF32 off): the scheduler's completions against solo
            # runs
            model = build_model(dataclasses.replace(cfg, dtype="float32"))
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            params = model.init(
                torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            print(f"serve fp32 weights: drawn on the card in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
            label = f"{name} serve fp32 virtual"
            zero()
            t = time.perf_counter()
            rep = scheduler(model, params, "virtual",
                            "meas_fp32").run(traffic)
            host = time.perf_counter() - t
            walks[label] = (None, read())
            events += rep.replan_events
            print(_report_line(label, rep, host) + f"; {smi}", flush=True)
            got = {c.rid: c.tokens for c in rep.completions}
            t = time.perf_counter()
            for r in traffic:
                solo = ServingEngine(cfg, model, params, max_batch=1,
                                     max_len=SERVE_MAX_LEN, device="cuda")
                want = solo.run([dataclasses.replace(r, arrival_s=0.0)]
                                )[0].tokens
                if got.get(r.rid) != want:
                    raise AssertionError(
                        "serve fp32: the scheduler's tokens differ from the "
                        "solo run's: " + _first_divergence(
                            model, params, r, got.get(r.rid, []), want))
            print(f"serve fp32: all {len(traffic)} scheduler completions "
                  f"equal the requests served alone by the fixed-batch "
                  f"engine, token for token ({sum(map(len, got.values()))} "
                  f"tokens; solo runs {time.perf_counter() - t:.1f} s); peak "
                  f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
                  flush=True)
            del model, params, solo
            torch.cuda.empty_cache()

            # bf16, the configuration's serving dtype
            model = build_model(cfg)
            torch.cuda.reset_peak_memory_stats()
            params = model.init(
                torch.Generator(device="cuda").manual_seed(0))
            rng = np.random.default_rng(0)
            reqs = [Request(rid=i, prompt=rng.integers(
                        0, cfg.vocab_size, size=rng.integers(4, 17)
                    ).astype(np.int32), max_new_tokens=SERVE_MAX_NEW,
                        temperature=(0.0, 0.7)[i % 2])
                    for i in range(SERVE_FIXED_REQUESTS)]
            engine = ServingEngine(cfg, model, params,
                                   max_batch=SERVE_MAX_BATCH,
                                   max_len=64 + SERVE_MAX_NEW,
                                   compiled=pf.entries[pf.buckets[-1]],
                                   device="cuda")
            engine.run(reqs[:1])                   # warm the allocator
            label = f"{name} serve bf16 fixed"
            zero()
            t = time.perf_counter()
            done = engine.run(reqs)
            host = time.perf_counter() - t
            _, report = engine.execute_plan()
            walks[label] = (None, read())
            tokens = sum(len(c.tokens) for c in done)
            if (tokens != SERVE_FIXED_REQUESTS * SERVE_MAX_NEW or not all(
                    0 <= v < cfg.vocab_size for c in done
                    for v in c.tokens)):
                raise AssertionError(
                    f"serve bf16 fixed: {tokens} tokens, want "
                    f"{SERVE_FIXED_REQUESTS * SERVE_MAX_NEW} in [0, "
                    f"{cfg.vocab_size})")
            print(f"{label}: {len(done)} requests (greedy and T=0.7 in "
                  f"turns) in batches of {SERVE_MAX_BATCH}, {tokens} tokens "
                  f"in {host:.3f} s ({tokens / host:.1f} tok/s on {smi}); "
                  f"execute_plan: {report.fidelity_summary()}", flush=True)
            label = f"{name} serve bf16 wall"
            zero()
            t = time.perf_counter()
            rep = scheduler(model, params, "wall", "meas_bf16").run(traffic)
            host = time.perf_counter() - t
            walks[label] = (None, read())
            events += rep.replan_events
            if (len(rep.completions) != len(traffic)
                    or rep.total_tokens != sum(r.max_new_tokens
                                               for r in traffic)):
                raise AssertionError(f"{label}: {len(rep.completions)} "
                                     f"completions, {rep.total_tokens} "
                                     f"tokens")
            print(_report_line(label, rep, host) + f"; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; {smi}",
                  flush=True)
            print(offered_load(label, traffic, rep), flush=True)
            for batch in (1, SERVE_MAX_BATCH):
                decode_breakdown(f"{name} bf16", model, params, batch)

            # the drift-triggered in-place replan: a simulated throttle
            # scales the recorded plan walls from 100 steps' cost on (the
            # reference's acceptance test), the bucket's monitor fires, and
            # the scheduler replans it, verifies the new plan, executes it
            # on the card and commits it only if its fidelity error is lower
            label = f"{name} serve bf16 throttled"
            zero()
            t = time.perf_counter()
            rep = scheduler(model, params, "virtual", "meas_throttle",
                            throttle=ThrottleSim(at_s=100 * cost, scale=2.5),
                            fidelity_every=4, fidelity_window=4,
                            drift_cooldown=2).run(traffic)
            host = time.perf_counter() - t
            walks[label] = (None, read())
            print(_report_line(label, rep, host), flush=True)
            if not rep.replan_events:
                raise AssertionError(f"{label}: the throttle triggered no "
                                     f"committed replan")
            events += rep.replan_events
            del model, params, engine
            torch.cuda.empty_cache()

        for ev in events:
            print(f"  replan [{ev.bucket}] at step {ev.step} ({ev.time_s:.3f}"
                  f" s): {ev.changes} nodes moved, fidelity error "
                  f"{ev.pre_fidelity:.3f} -> {ev.post_fidelity:.3f}, key "
                  f"{ev.old_key} -> {ev.new_key}", flush=True)
            if not ev.post_fidelity < ev.pre_fidelity:
                raise AssertionError(f"serve: a committed replan did not "
                                     f"lower the fidelity error")
        # hold every executed plan the entries above did not hold: its run
        # against run_oracle and every kernel call of one of its requests
        if not executed:
            raise AssertionError("serve: no plan execution was recorded")
        committed = {ev.new_key for ev in events}
        for key, c in executed.items():
            if key in held:
                continue
            shape = tuple(c.executor(device="cuda").input_template().shape)
            tag = (f"{name} b{shape[0]} plan {key[:8]} "
                   f"{'replanned' if key in committed else 'not committed'}")
            make = decode_input(*shape)
            counts, exe, _, _ = main_path(tag, c, make, shape,
                                          PORTFOLIO_REQUESTS, SERVE_E2E_RTOL)
            walks[tag] = (tag, counts)
            hold_walk_calls(tag, kernel_calls(exe, make(0)),
                            expected_counts(c.plan), peaks, tallies)
            held.add(key)
        print(f"serve: {len(executed)} distinct plans executed by the "
              f"scheduler and the engine, each held against its plain "
              f"version ({len(committed)} committed replans): "
              + ", ".join(sorted(executed)), flush=True)
    for k in ("split_matmul", "decode_attention"):
        for walk in ("fp32 virtual", "bf16 fixed", "bf16 wall",
                     "bf16 throttled"):
            walk = f"{name} serve {walk}"
            if not walks[walk][1][k]:
                raise AssertionError(f"{k} was not launched on the {walk} "
                                     f"walk")
    return walks


def tune_ops():
    """The sweep's ops, one per kind at the main paths' shapes: (label,
    op).  The M = 64 linear is the one op off the paths: the tiled product
    only runs at M > 8."""
    from repro_torch.core.types import AttnOp, ConvOp, LinearOp, SSMOp
    return [
        ("VGG16 n7 conv", ConvOp(56, 56, 256, 256)),       # P = 784
        ("zamba2-7b in_proj M=1", LinearOp(1, 3584, 5696)),
        ("zamba2-7b in_proj M=4", LinearOp(4, 3584, 5696)),
        ("q_proj M=64", LinearOp(64, 3584, 3584)),
        ("zamba2-7b b8.attn S=3072", AttnOp(H=32, S=3072, KV=32, hd=112)),
        ("SSD prefill T=4096", SSMOp(T=4096, H=112, hd=64, N=64)),
    ]


def tune_operands(op, gen):
    """Seeded float32 arguments of the op's kernel call on the card, drawn
    as the kernel phases draw them, with the wrapper, its plain version
    (for a launch), the call's (bytes, operations) and what the kernel's
    planner picks for it (the default launch)."""
    import importlib

    from repro_torch.kernels import build, registry
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.split_matmul.split_matmul import (
        split_matmul, split_matmul_plain)
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        CHUNK, ssd_chunk_scan, ssd_chunk_scan_plain)
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul, hadamard_matmul_plain, plan_hadamard)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    da, sm, sc = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
                  for m in ("decode_attention", "split_matmul", "ssd_chunk"))
    kind = registry.op_kind(op)
    if kind == "linear":
        m, k, n = op.L, op.C_in, op.C_out
        args = (rand(m, k), rand(k, n) / k ** 0.5, 0, n)
        plan = sm.plan_call(*args)
        return (args, split_matmul,
                lambda launch, *a: split_matmul_plain(*a),
                lambda elt: (elt * (m * k + k * n + m * n), 2 * m * k * n),
                f"bm{plan.mt}/bn{plan.tile}" if plan.variant == sm.TILED
                else f"splits {plan.splits} x {plan.col_tiles} column tiles")
    if kind == "conv":
        p = -(-op.H_in // 2) * -(-op.W_in // 2)
        k, n = op.C_in, op.C_out
        args = (rand(16, p, k), rand(16, k, n) / k ** 0.5)
        plan = plan_hadamard(16, p, k, n, 4, (0, 0, 0), build.sm_count(0))
        return (args, hadamard_matmul,
                lambda launch, *a: hadamard_matmul_plain(*a),
                lambda elt: (elt * 16 * (p * k + k * n + p * n),
                             2 * 16 * p * k * n),
                f"bm{plan.bm}/bn{plan.bn}, {plan.blocks} blocks")
    if kind == "attention":
        h, kv, hd, s = op.H, op.KV, op.hd, op.S
        args = (rand(h, hd), rand(s, kv, hd), rand(s, kv, hd), s - 1, 0)
        plan = da.plan_call(*args)
        return (args,
                lambda *a, launch: decode_attention(*a[:4], window=a[4],
                                                    launch=launch),
                lambda launch, *a: decode_attention_plain(*a[:4],
                                                          window=a[4]),
                lambda elt: (elt * (2 * h * hd + 2 * s * kv * hd) + 4 * h,
                             4 * h * s * hd),
                f"run_tiles {plan.run_tiles} ({plan.nsplit} runs per KV "
                f"head)")
    b, t, h, hd, n = 1, op.T, op.H, op.hd, op.N
    args = (rand(b, t, h, hd), rand(b, t, n) / n ** 0.5,
            rand(b, t, n) / n ** 0.5, 0.05 + 0.2 * torch.sigmoid(rand(b, t, h)),
            -(0.1 + rand(h).abs()), rand(b, h, hd, n) / n ** 0.5)
    plan = sc.plan_call(*args, torch.empty_like(args[5]))
    return (args, ssd_chunk_scan,
            lambda launch, *a: ssd_chunk_scan_plain(
                *a, chunk=launch.get("chunk") or CHUNK),
            lambda elt: (elt * (2 * b * t * h * hd + 2 * b * t * n + b * t * h
                                + h + 2 * b * h * hd * n),
                         6 * b * t * h * hd * n),
            f"chunk {plan.chunk}")


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def sweep_op(label: str, op, gen, peaks: dict) -> dict:
    """Every candidate launch of the op's Hopper spec, both search modes'
    grids (`LaunchSpec.configs`, `preserve_numerics=False`): each held
    against the plain version in float32 and bfloat16 within
    `KERNEL_RTOL`, each output-tiling one `torch.equal` to the default
    launch's output in float32, each timed in float32 (`time_ms`).
    Prints each candidate's time, the default's, the winner of each
    search mode with `autotune`'s hysteresis and the winner's bound;
    returns {launch label: ms}."""
    from repro_torch.kernels import registry, tiles
    from repro_torch.runtime.autotune import TUNE_HYSTERESIS
    kind = registry.op_kind(op)
    spec = tiles.launch_spec(kind)
    extents = registry.launch_extents(op)
    grid = spec.configs(extents, preserve_numerics=False)
    preserving = spec.configs(extents)
    args32, kernel, plain, work, picked = tune_operands(op, gen)
    default = _outputs(kernel(*args32, launch=spec.default()))
    times, errs, identical = {}, dict.fromkeys(DTYPES, 0.0), 0
    for launch in grid:
        for dtype in DTYPES:
            args = tuple(a.to(dtype) if torch.is_tensor(a) else a
                         for a in args32)
            got = _outputs(kernel(*args, launch=launch))
            want = _outputs(plain(launch, *args))
            for i, (g, w) in enumerate(zip(got, want)):
                errs[dtype] = max(errs[dtype], check(
                    f"tune {label} {launch.label()} {dtype} output {i}", g,
                    w, KERNEL_RTOL[dtype]))
            if dtype != torch.float32:
                continue
            tiling = not any(spec.param(n).reduction
                             for n, _ in launch.values)
            if tiling and not all(torch.equal(g, d)
                                  for g, d in zip(got, default)):
                raise AssertionError(
                    f"tune {label}: the output-tiling launch "
                    f"{launch.label()} is not bit-identical to the default "
                    f"launch in float32")
            identical += tiling
            times[launch.label()] = time_ms(
                lambda: kernel(*args, launch=launch))
    base = times["default"]

    def winner(cands):
        best = min(cands, key=lambda c: times[c.label()])
        if times[best.label()] > base * (1.0 - TUNE_HYSTERESIS):
            return spec.default()
        return best
    bnd, tb, to = bound_ms(*work(4), torch.float32, peaks)
    shown = ", ".join(f"{c.label()} {times[c.label()]:.4f}" for c in grid)
    print(f"tune {label} ({registry.op_label(op)}, {kind}; the planner "
          f"picks {picked}): float32 ms {shown}; {len(grid)} candidates "
          f"within KERNEL_RTOL of the plain version (max_abs_err float32 "
          f"{errs[torch.float32]:.3e}, bfloat16 {errs[torch.bfloat16]:.3e}),"
          f" {identical} output-tiling ones (the default included) "
          f"bit-identical to the default launch", flush=True)
    for mode, cands in (("numerics-preserving", preserving),
                        ("all candidates", grid)):
        best = winner(cands)
        ms = times[best.label()]
        print(f"tune {label}: {mode} winner {best.label()} {ms:.4f} ms "
              f"(default {base:.4f} ms, {base / ms - 1:+.1%}; "
              f"{'beats' if not best.is_default else 'none beats'} the "
              f"default by more than {TUNE_HYSTERESIS:.0%}); bound "
              f"{bnd:.4f} ms by {'bytes' if tb >= to else 'operations'} "
              f"({bnd / ms:.1%} of it)", flush=True)
    return times


def observed_launches(calls: dict) -> dict:
    """(kernel, launch label) -> calls, of one request's kernel calls
    (`kernel_calls`: a signature's last element is its launch)."""
    seen = {}
    for name, sigs in calls.items():
        for sig, (n, _) in sigs.items():
            label = "default" if sig[-1] is None else sig[-1].label()
            seen[(name, label)] = seen.get((name, label), 0) + n
    return seen


def expected_launches(exe) -> dict:
    """(kernel, launch label) -> calls of one request of the executor's
    per-node walk: each node's tuned launch, on a split's sides fitted to
    each side (a channel side's width, a typed side's sub-op)."""
    from repro_torch.kernels import registry, tiles
    kernel = {"linear": "split_matmul", "conv": "hadamard_matmul",
              "attention": "decode_attention", "ssm": "ssd_chunk_scan"}
    want = {}
    for spec, launch in zip(exe.specs, exe.launches):
        if spec.op is None or not registry.launch_extents(spec.op):
            continue
        launch = launch or tiles.Launch(spec.unit)
        if not spec.coexec:
            sides = [launch]
        elif spec.axis == "channel":
            sides = [registry.fit_launch(launch, spec.op, n=w)
                     for w in (spec.c_fast, spec.c_slow) if w]
        else:
            axis = registry.axis_spec(spec.unit, spec.axis)
            sides = [registry.fit_launch(launch, axis.sub(spec.op, n))
                     for n in (spec.c_fast, axis.size(spec.op) - spec.c_fast)]
        for side in sides:
            key = (kernel[spec.unit], side.label())
            want[key] = want.get(key, 0) + 1
    return want


def tuned_path(name: str, network, target, mode: str, predictors,
               make_input, out_shape, tmp: Path, peaks: dict,
               tallies: dict) -> dict:
    """`compile(tune=True)` of one main path into fresh plan and tune
    caches: cold (its measurements counted), then warm (no measurement,
    tune-cache hits only); its key against the untuned compile's, its
    document the untuned one's but for `provenance.tune`; saved with its
    sidecar, loaded strictly, run per node and fused against its
    run_oracle (`main_path`, `fused_path`), every kernel call of one
    request checked to carry its op's tuned launch fitted to its side
    (`check_launches`); then the same plan tuned with its reduction axes
    too (`preserve_numerics=False`), run and checked alike, its kernel
    calls held against their plain versions (`hold_walk_calls`); the
    tuned, relaxed and untuned walls in turns.  Returns the walks."""
    import repro_torch
    import repro_torch.runtime.autotune as at
    from repro_torch.api import CompiledNetwork
    from repro_torch.kernels.registry import op_label

    measured = [0]
    real = at.measure_tile_us

    def counted(*a, **k):
        measured[0] += 1
        return real(*a, **k)

    kw = dict(mode=mode, cache=tmp / "plans", predictors=predictors)
    runs = {}
    at.measure_tile_us = counted
    try:
        for run in ("cold", "warm"):
            tc = at.TuneCache(tmp / "tune")
            measured[0] = 0
            t = time.perf_counter()
            net = repro_torch.compile(network, target, tune=True,
                                      tune_cache=tc, **kw)
            runs[run] = (net, time.perf_counter() - t, measured[0], tc)
    finally:
        at.measure_tile_us = real
    untuned = repro_torch.compile(network, target, **kw)
    (tuned, cold_s, cold_n, cold_tc), (warm, warm_s, warm_n, warm_tc) = \
        runs["cold"], runs["warm"]
    ops = len(tuned.tuned)
    if tuned.from_cache or not warm.from_cache or warm.key != tuned.key:
        raise AssertionError(f"{name} tuned: the first compile must miss "
                             f"and the second hit the plan cache")
    if warm_n or warm_tc.misses or warm_tc.hits != ops \
            or warm.tuned != tuned.tuned:
        raise AssertionError(f"{name} tuned: the warm compile measured "
                             f"{warm_n} times with {warm_tc.misses} tune "
                             f"misses and {warm_tc.hits} hits for {ops} ops")
    a = json.loads(untuned.plan.dumps())
    b = json.loads(tuned.plan.dumps())
    tag = b["provenance"].pop("tune")
    if tuned.key == untuned.key or a != b or \
            tag != at.tune_cache_version():
        raise AssertionError(f"{name} tuned: the tuned document must be "
                             f"the untuned one with provenance.tune only")
    moved = {op: l for op, l in tuned.launches.items() if not l.is_default}
    print(f"{name} tuned: {ops} unique ops, {cold_n} measurements "
          f"({cold_tc.misses} tune misses) cold in {cold_s:.3f} s; warm "
          f"{warm_s:.3f} s with {warm_n} measurements and {warm_tc.hits} "
          f"tune-cache hits; key {tuned.key} (untuned {untuned.key}); the "
          f"documents differ only in provenance.tune = {tag}; launches off "
          f"the default: " + ("; ".join(sorted(
              f"{op_label(op)} -> {l.label()}" for op, l in moved.items()))
              or "none"), flush=True)
    path = tuned.save(tmp / f"{name}.tuned.coexec.json")
    loaded = CompiledNetwork.load(path)
    if loaded.launches != tuned.launches or loaded.key != tuned.key:
        raise AssertionError(f"{name} tuned: the saved artifact and its "
                             f"sidecar do not load back as they were")
    label = f"{name} tuned"
    counts, exe, want, refs = main_path(label, loaded, make_input, out_shape,
                                        REPLAN_REQUESTS, E2E_RTOL[name])
    walks = {label: (None, counts),
             f"{label} fused": (None, fused_path(label, exe, want, refs,
                                                 E2E_RTOL[name]))}
    check_launches(label, exe, kernel_calls(exe, make_input(0)))

    # the relaxed search (preserve_numerics=False) of the same plan: the
    # split-K factors, runs and chunks too, tolerance-exact, run likewise
    t = time.perf_counter()
    entries = at.annotate_plan_tiles(loaded.plan, cache=at.TuneCache(
        tmp / "tune"), preserve_numerics=False)
    relaxed = CompiledNetwork(plan=loaded.plan, target=loaded.target,
                              mode=loaded.mode, tuned=entries)
    print(f"{name} relaxed: {len(entries)} ops searched with their "
          f"reduction axes in {time.perf_counter() - t:.3f} s; launches off "
          f"the default: " + ("; ".join(sorted(
              f"{op_label(op)} -> {l.label()}"
              for op, l in relaxed.launches.items() if not l.is_default))
              or "none"), flush=True)
    label_r = f"{name} relaxed"
    counts, exe_r, want, refs = main_path(label_r, relaxed, make_input,
                                          out_shape, REPLAN_REQUESTS,
                                          E2E_RTOL[name])
    walks[label_r] = (label_r, counts)
    walks[f"{label_r} fused"] = (label_r, fused_path(label_r, exe_r, want,
                                                     refs, E2E_RTOL[name]))
    calls = kernel_calls(exe_r, make_input(0))
    check_launches(label_r, exe_r, calls)
    hold_walk_calls(label_r, calls, want, peaks, tallies)
    alternating_walls({label: exe, label_r: exe_r, f"{name} untuned":
                       untuned.executor(device="cuda")},
                      make_input(REQUESTS), TUNE_WALL_PAIRS)
    return walks


def check_launches(label: str, exe, calls: dict) -> None:
    """Every kernel call of one request of `exe`'s per-node walk
    (`kernel_calls`) carries its op's tuned launch fitted to its side
    (`expected_launches`)."""
    seen = observed_launches(calls)
    expect = expected_launches(exe)
    if seen != expect:
        raise AssertionError(f"{label}: the kernels were called with "
                             f"{seen}, the tuned launches give {expect}")
    print(f"{label}: every kernel call carried its op's tuned launch: "
          + ", ".join(f"{k} {l} x{n}" for (k, l), n in sorted(seen.items())),
          flush=True)


def tune_input(name: str, artifact: Path, compiled) -> tuple:
    """(network, target, mode, predictors) of a main path, as the compile
    phase compiled it."""
    import repro_torch
    from repro_torch.graph.frontends import from_model
    doc = json.loads(artifact.read_text())
    network = from_model(ZAMBA, **ZAMBA_GRAPH) if name == ZAMBA else name
    return (network, repro_torch.Target.from_json(doc["target"]),
            doc["mode"], compiled.predictors)


def tune_phase(peaks: dict, tallies: dict, tune_inputs: dict) -> dict:
    """The autotuner on the card: (a) the sweep (`sweep_op`) of one op
    per kind; (b) the tuned compiles of VGG16 and the zamba2-7b step
    (`tuned_path`).  Returns the tuned walks."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    t = time.perf_counter()
    for label, op in tune_ops():
        sweep_op(label, op, gen, peaks)
    print(f"tune sweep: {time.perf_counter() - t:.1f} s", flush=True)
    walks = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_tune_") as tmp:
        for name, make_input, out_shape in TUNE_PATHS:
            network, target, mode, predictors = tune_inputs[name]
            walks.update(tuned_path(name, network, target, mode, predictors,
                                    make_input, out_shape, Path(tmp, name),
                                    peaks, tallies))
            torch.cuda.empty_cache()
    return walks


def image_input(size: int):
    """Seeded (1, size, size, 3) requests of a CNN path."""
    def make(r: int) -> np.ndarray:
        return np.random.default_rng(100 + r).standard_normal(
            (1, size, size, 3)).astype(np.float32)
    return make


vgg16_input = image_input(224)


def decode_input(batch: int, d: int = None):
    """Seeded (batch, d) requests of a decode step (d: zamba2-7b's
    width unless given)."""
    def make(r: int) -> np.ndarray:
        return np.random.default_rng(300 + r).standard_normal(
            (batch, d or ZAMBA_D)).astype(np.float32)
    return make




#: the device-kernel name of each wrapper's main pass on the main paths
#: (both paths run `split_matmul` at M = 1: the split-K GEMV; the
#: zamba2-7b step runs the SSD scan at T = 1: the decode kernel)
TRACE_NAMES = {"split_matmul": "splitk_gemv<float",
               "hadamard_matmul": "hadamard_gemm<float",
               "decode_attention": "attn_runs<float",
               "ssd_chunk_scan": "ssd_decode<float"}
#: CUDA runtime calls by which the host puts work on the card
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
                     "cudaMemset", "cudaGraphLaunch")
#: second passes, counted apart from their wrappers' launches
SECOND_PASSES = {"split_matmul": "splitk_reduce<float",
                 "decode_attention": "attn_merge<float"}


def device_breakdown(name: str, exe, x, requests: int = 2,
                     top: int = 12, fused: bool = False) -> None:
    """`requests` requests under torch.profiler: device time per request
    of the kernels they ran, by kernel name, against the request wall; and
    each wrapper's launches in the trace against its launch counter (for
    the fused walk, the launches credited at the graphs' replays) and the
    graph launches the trace shows.  Raises if the trace holds no device
    time at all."""
    counters = kernel_counters()
    exe.run(x, fused=fused)
    before = {k: fn.launches for k, fn in counters.items()}
    if fused:
        name = f"{name} fused"
    rows, busy, wall, calls = _profile(name, lambda: exe.run(x, fused=fused),
                                       requests)
    print(f"profile {name}: {requests} requests; per request wall "
          f"{wall:.3f} ms under the profiler, kernels {busy:.3f} ms of "
          f"device time in {sum(r[1] for r in rows) / requests:g} launches "
          f"(the two streams may overlap, so the card is idle for at least "
          f"{1 - busy / wall:.1%} of the wall); host calls per request "
          f"{sum(calls.values()):g} ("
          + ", ".join(f"{k} {n:g}" for k, n in sorted(calls.items())) + ")")
    for ms, count, key in rows[:top]:
        print(f"  {ms:8.3f} ms {count:4d}x {key[:100]}")
    seen = {k: sum(c for _, c, key in rows if TRACE_NAMES[k] in key)
            for k in KERNEL_NAMES}
    second = {k: sum(c for _, c, key in rows if pattern in key)
              for k, pattern in SECOND_PASSES.items()}
    graphs = round(calls.get("cudaGraphLaunch", 0) * requests)
    print(f"profile {name}: launches in the trace / by the counters over "
          f"the {requests} requests: " + ", ".join(
              f"{k} {seen[k]}/{counters[k].launches - before[k]}"
              for k in KERNEL_NAMES
              if counters[k].launches - before[k] or seen[k])
          + "; second passes in the trace: " + ", ".join(
              f"{k} {n}" for k, n in second.items())
          + f"; cudaGraphLaunch calls in the trace: {graphs}", flush=True)
    for k in KERNEL_NAMES:
        counted = counters[k].launches - before[k]
        if counted and not seen[k]:
            print(f"profile {name}: the trace lists none of the {counted} "
                  f"{k} launches the counter holds", flush=True)


#: the zamba2-7b path's graph: 9 blocks, a 4096-position KV cache; its
#: model width (d_model)
ZAMBA_GRAPH = dict(blocks=9, cache_len=4096)
ZAMBA_D = 3584

#: the calibrate phase: its paths, the per-node runs it records (then one
#: fused run), and the requests each replanned walk runs
CALIBRATE_PATHS = (VGG, ZAMBA)
RECORD_RUNS = 2
REPLAN_REQUESTS = 2

#: the portfolio phase: the committed zamba2-7b portfolio, the requests
#: each of its entries runs per walk, and the live step (batch, seq) whose
#: entry it recalibrates, replans and replaces (`select` gives b4s256)
PORTFOLIO = ARTIFACTS / "zamba2-7b_b9_moto2022_t1.portfolio.json"
PORTFOLIO_REQUESTS = 2
PORTFOLIO_STEP = (4, 200)

#: the tune phase's tuned compiles: (path, request maker, output shape),
#: each run for `REPLAN_REQUESTS` requests per walk, and its rounds of
#: tuned and untuned walls in turns
TUNE_PATHS = ((VGG, vgg16_input, (1, 1000)),
              (ZAMBA, decode_input(1), (1, ZAMBA_D)))
TUNE_WALL_PAIRS = 4

#: the serve phase: the model (codeqwen1.5-7b at its published widths and
#: full depth), its portfolio's (batch, seq) buckets, the fixed-batch
#: engine's requests, new tokens per request and batch, the scheduler's
#: per-slot cache length, its Poisson requests and plan-execution cadence
SERVE_ARCH = "codeqwen15_7b"
SERVE_BUCKETS = ((1, 64), (4, 64))
SERVE_FIXED_REQUESTS = 8
SERVE_MAX_NEW = 12
SERVE_MAX_BATCH = 4
SERVE_MAX_LEN = 64
SERVE_TRAFFIC = 24
SERVE_FIDELITY_EVERY = 8
#: the reduced model's logits on the card against the CPU's, relative to
#: the largest |CPU logit| (fp32 sums in another order through 2 layers);
#: a serve plan's run against its run_oracle, as zamba2-7b's (fp32 GEMV
#: sums to K = 13440 and the split attention's merge)
SERVE_LOGIT_RTOL = 1e-4
SERVE_E2E_RTOL = 1e-4

#: the main paths: (name, committed artifact, request maker, output shape);
#: the compile phase compiles each and must reproduce its artifact
PATHS = [
    (VGG, ARTIFACT, vgg16_input, (1, 1000)),
    (ZAMBA, ZAMBA_ARTIFACT, decode_input(1), (1, ZAMBA_D)),
    (R18, ARTIFACTS / "resnet18_moto2022.coexec.json", image_input(224),
     (1, 1000)),
    (R34, ARTIFACTS / "resnet34_moto2022.coexec.json", image_input(224),
     (1, 1000)),
    (INC, ARTIFACTS / "inception_v3_moto2022.coexec.json", image_input(299),
     (1, 1000)),
]


class Phases:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f} s (total "
              f"{now - self.t0:.1f} s)", flush=True)
        self.t = now


SOURCES = {
    "split_matmul": ("src/repro_torch/csrc/split_matmul.cu",
                     "src/repro/kernels/split_matmul/split_matmul.py:44"),
    "hadamard_matmul": ("src/repro_torch/csrc/hadamard_matmul.cu",
                        "src/repro/kernels/winograd_conv/winograd_conv.py:55"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:72"),
    "ssd_chunk_scan": ("src/repro_torch/csrc/ssd_chunk.cu",
                       "src/repro/kernels/ssd_chunk/ssd_chunk.py:67"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    phases = Phases()
    smi = nvidia_smi_line()
    print(smi, flush=True)
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
    phases.done("build")

    peaks = card_peaks()
    results = {}
    for name, phase in (("split_matmul", split_matmul_phase),
                        ("hadamard_matmul", hadamard_phase),
                        ("decode_attention", decode_attention_phase),
                        ("ssd_chunk_scan", ssd_phase)):
        results[name] = phase(peaks)
        phases.done(f"kernel {name}")
    if "--kernels-only" in sys.argv[1:]:
        return 0

    compiled_nets = compile_phase(PATHS)
    tuned_names = {name for name, _, _ in TUNE_PATHS}
    tune_inputs = {name: tune_input(name, artifact, compiled_nets[name])
                   for name, artifact, _, _ in PATHS if name in tuned_names}
    phases.done("compile")

    # each walk ("<path>", "<path> fused", "<path> bf16", ...) with the
    # key of its float32 times in the tallies (None: no times) and its
    # launch counts
    walks = {}
    kept = {}                  # the calibrate phase's compiled networks
    for name, _, make_input, out_shape in PATHS:
        compiled = compiled_nets.pop(name)
        counts, exe, want, refs = main_path(name, compiled, make_input,
                                            out_shape, REQUESTS,
                                            E2E_RTOL[name])
        walks[name] = (name, counts)
        device_breakdown(name, exe, make_input(REQUESTS))
        phases.done(f"{name} per-node")
        walks[f"{name} fused"] = (name, fused_path(name, exe, want, refs,
                                                   E2E_RTOL[name]))
        alternating_walls({name: exe}, make_input(REQUESTS), WALL_PAIRS)
        device_breakdown(name, exe, make_input(REQUESTS), fused=True)
        phases.done(f"{name} fused")
        if name in BF16_PATHS:
            walks.update((walk, (None, c)) for walk, c in
                         bf16_path(name, compiled, want, refs).items())
            phases.done(f"{name} bf16")
        if name in CALIBRATE_PATHS:
            kept[name] = (compiled, make_input, out_shape)
        del compiled, exe, refs
        torch.cuda.empty_cache()
    for k in KERNEL_NAMES:
        for suffix in ("", " fused"):
            if sum(walks[f"{p[0]}{suffix}"][1][k] for p in PATHS) == 0:
                raise AssertionError(f"{k} was not launched on a main "
                                     f"path's{suffix or ' per-node'} walk")

    for name in CALIBRATE_PATHS:
        cal_walks, _ = calibrate_path(name, name, *kept.pop(name), peaks,
                                      results)
        walks.update(cal_walks)
        phases.done(f"{name} calibrate")
        torch.cuda.empty_cache()
    walks.update(portfolio_phase(peaks, results))
    phases.done("portfolio")
    walks.update(serve_phase(peaks, results, smi))
    phases.done("serve")
    walks.update(tune_phase(peaks, results, tune_inputs))
    phases.done("tune")

    def by_path(name: str, t: Tally) -> dict:
        """Each walk's launches of kernel `name`, with the float32 times
        of one request where the walk has them."""
        out = {}
        for walk, (key, counts) in walks.items():
            if not counts[name] and key not in t.by_path:
                continue
            out[walk] = {"launches": counts[name]}
            if key in t.by_path:
                out[walk].update(
                    {k: (None if k == "library_ms" and not t.library else v)
                     for k, v in t.by_path[key].items()})
        return out

    mains = [p[0] for p in PATHS]
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": sum(c[name] for _, c in walks.values()),
        "max_abs_err": t.max_abs_err,
        "max_abs_err_bf16": t.max_abs_err_bf16,
        "ms": t.total("ms", mains), "plain_ms": t.total("plain_ms", mains),
        "bound_ms": t.total("bound_ms", mains),
        "bound_by": ("bytes" if t.total("t_bytes", mains)
                     >= t.total("t_ops", mains) else "operations"),
        "library_ms": t.total("library_ms", mains),
        "per": (f"launches: the {REQUESTS} requests of each main path's "
                f"per-node and fused walks, the {BF16_REQUESTS} of each "
                f"bf16 walk, the {RECORD_RUNS + 1} recorded runs of each "
                f"calibrate walk, the {REPLAN_REQUESTS} requests of each "
                f"replanned walk, the {PORTFOLIO_REQUESTS} of each "
                f"portfolio entry's walks, of each serve bucket's plan and "
                f"of each tuned walk, and the serve walks' plan executions "
                f"(every "
                f"{SERVE_FIDELITY_EVERY} scheduler steps, one execute_plan); "
                f"times: one request of each main path, float32 (by_path: "
                f"one request of each walk)"),
        "by_path": by_path(name, t)}
        for name, t in results.items()]}
    phases.done("paths")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
