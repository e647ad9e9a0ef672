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
3. one phase per kernel at the main paths' shapes plus off-path ones:
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
4. five main paths (`PATHS`), each loaded through
   `repro_torch.CompiledNetwork` from a committed artifact (strict load:
   the port's static verifier runs first) and run on two CUDA-stream
   groups for a few seeded inputs ("requests"), each output held against
   `run_oracle` on the card, with every kernel's launch counter set to 0
   just before the path and read just after:
   - VGG16 at 224x224x3 (`split_matmul`, `hadamard_matmul`);
   - a zamba2-7b decode step, 9 blocks, 4096-position KV cache
     (`split_matmul`, `decode_attention` on both sides of a kv-block split,
     `ssd_chunk_scan`);
   - resnet18 and resnet34 at 224x224x3 (`split_matmul`; direct convs on
     two streams, projection shortcuts through `_adapt`);
   - inception_v3 at 299x299x3 (`split_matmul`, `hadamard_matmul` on both
     sides of its one Winograd node; 68 fused segments);
5. two more requests of each path under torch.profiler: device time by
   kernel, and each kernel's launches in the trace beside its counter;
6. the fused segment walk of each path (`run(fused=True)`): every fused
   segment captured once as a CUDA graph (each printed with its kind, its
   nodes and the kernel launches its graph holds), then the same seeded
   requests, each output `torch.equal` to the per-node walk's and within
   `E2E_RTOL` of `run_oracle`, with the launch counts (credited at each
   replay), reshard and elided counts of the per-node walk and one sync
   per segment; the two walks' median walls from one alternating run
   (per-node, fused, per-node, fused, ...); two fused requests under
   torch.profiler, with each kernel's launches in the trace beside its
   credited counter and the graph launches the trace shows;
7. a bfloat16 run of VGG16 and the zamba2-7b step (`BF16_PATHS`):
   `executor(dtype="bfloat16")`, per-node and fused, `BF16_REQUESTS`
   requests each, held against the float32 `run_oracle` at `BF16_RTOL`
   of its largest |value|, with the same launch counts;
8. a JSON line of per-kernel numbers, then the result line.  Each phase
   prints its seconds.
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


_FLUSH = None
_SPIN_CYCLES_PER_MS = None


def _spin_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms of device time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(cycles)                  # warm
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of one call.  Before each timed call a 128 MB
    write evicts the 50 MB L2 cache, then a spin kernel holds the stream
    for twice the host's time to enqueue the call (capped at 100 ms): the
    call and its end event are queued before the start event fires, so the
    events bracket the call's device work and not the host's launch
    overhead (allocations, ctypes, enqueue)."""
    global _FLUSH, _SPIN_CYCLES_PER_MS
    if _FLUSH is None:
        _FLUSH = torch.empty(32 * 1024 * 1024, device="cuda")
        _SPIN_CYCLES_PER_MS = _spin_cycles_per_ms()
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spin = int(_SPIN_CYCLES_PER_MS * min(100.0, 2 * host_ms + 0.2))
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
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


class Tally:
    """One kernel's numbers: max errors, and times summed over the
    launches of one request of each main path (float32)."""

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

    def total(self, key: str):
        if key == "library_ms" and not self.library:
            return None
        return sum(p[key] for p in self.by_path.values())


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


def split_matmul_phase(peaks: dict) -> Tally:
    from repro_torch.kernels.split_matmul.split_matmul import (
        plan_call, split_matmul, split_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tally = Tally()
    for label, m, k, n, c0, width, per_path in SPLIT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            got = split_matmul(x, w, c0, width)
            err = check(f"split_matmul {label} {dtype}", got,
                        split_matmul_plain(x, w, c0, width),
                        KERNEL_RTOL[dtype])
            if not torch.equal(got, split_matmul(x, w, c0, width)):
                raise AssertionError(f"split_matmul {label} {dtype}: two "
                                     f"calls on the same inputs differ")
            plan = plan_call(x, w, c0, width)
            size = x.element_size()
            times = _times(lambda: split_matmul(x, w, c0, width),
                           lambda: split_matmul_plain(x, w, c0, width),
                           lambda: torch.matmul(x, w[:, c0:c0 + width]),
                           size * (m * k + k * width + m * width),
                           2 * m * k * width, dtype, peaks)
            _report("split_matmul", label, dtype, err, times,
                    f"M={m} K={k} N={n} c0={c0} width={width} "
                    f"[variant {plan.variant} {plan.col_tiles}x"
                    f"{plan.splits} blocks, k_chunk {plan.k_chunk}]")
            tally.add(dtype, err, per_path, times)
    return tally


def hadamard_phase(peaks: dict) -> Tally:
    from repro_torch.kernels import build
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul, hadamard_matmul_plain, plan_hadamard)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tally = Tally()
    for label, p, k, n, per_path in HADAMARD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.randn((16, p, k), generator=gen, device="cuda").to(dtype)
            v = (torch.randn((16, k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            got = hadamard_matmul(u, v)
            err = check(f"hadamard_matmul {label} {dtype}", got,
                        hadamard_matmul_plain(u, v), KERNEL_RTOL[dtype])
            plan = plan_hadamard(16, p, k, n, u.element_size(),
                                 (u.data_ptr(), v.data_ptr(),
                                  got.data_ptr()), build.sm_count(0))
            times = _times(lambda: hadamard_matmul(u, v),
                           lambda: hadamard_matmul_plain(u, v),
                           lambda: torch.bmm(u, v),
                           u.element_size() * 16 * (p * k + k * n + p * n),
                           2 * 16 * p * k * n, dtype, peaks)
            _report("hadamard_matmul", label, dtype, err, times,
                    f"P={p} K={k} N={n} [{plan.bm}x{plan.bn} tile, "
                    f"{plan.blocks} blocks, vec {int(plan.vec)}]")
            tally.add(dtype, err, per_path, times)
    return tally


def decode_attention_phase(peaks: dict) -> Tally:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_attention_plain, plan_call, valid_range)
    gen = torch.Generator(device="cuda").manual_seed(13)
    tally = Tally()
    for label, h, kv, hd, s, pos, window, per_path in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for shape in ((h, hd), (s, kv, hd),
                                                (s, kv, hd)))
            out, lse = decode_attention(q, k, v, pos, window=window)
            want, want_lse = decode_attention_plain(q, k, v, pos,
                                                    window=window)
            err = check(f"decode_attention {label} {dtype}", out, want,
                        KERNEL_RTOL[dtype])
            check(f"decode_attention {label} {dtype} lse", lse, want_lse,
                  KERNEL_RTOL[torch.float32])        # fp32 sums in both
            again = decode_attention(q, k, v, pos, window=window)
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"decode_attention {label} {dtype}: two "
                                     f"calls on the same inputs differ")
            plan = plan_call(q, k, v, pos, window)
            lo, hi = valid_range(s, pos, window)
            n = hi - lo + 1
            # the library call: the attended positions, (1, heads, S, hd)
            q4 = q[None, :, None, :]
            k4 = k[lo:hi + 1].permute(1, 0, 2)[None]
            v4 = v[lo:hi + 1].permute(1, 0, 2)[None]
            times = _times(
                lambda: decode_attention(q, k, v, pos, window=window),
                lambda: decode_attention_plain(q, k, v, pos, window=window),
                lambda: sdpa(q4, k4, v4, enable_gqa=h != kv),
                q.element_size() * (2 * h * hd + 2 * n * kv * hd) + 4 * h,
                4 * h * n * hd, dtype, peaks)
            _report("decode_attention", label, dtype, err, times,
                    f"H={h} KV={kv} hd={hd} S={s} pos={pos} window={window} "
                    f"[variant {plan.variant}, {plan.nsplit} runs of "
                    f"{plan.run_len} over {lo}..{hi}, tile {plan.tile}, "
                    f"{plan.stages} stages, {plan.blocks} blocks]")
            tally.add(dtype, err, per_path, times)
    return tally


def ssd_phase(peaks: dict) -> Tally:
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        CHUNK, CHUNKED, DECODE_T_MAX, SsdPlan, launch_uncounted, plan_call,
        smem_bytes, ssd_chunk_scan, ssd_chunk_scan_plain)
    if DECODE_T_MAX not in {case[2] for case in SSD_CASES}:
        raise AssertionError(f"SSD_CASES has no case at DECODE_T_MAX = "
                             f"{DECODE_T_MAX}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    tally = Tally(library=False)          # no one PyTorch call computes it
    floor = time_ms(lambda: torch.cuda._sleep(0))
    print(f"ssd_chunk_scan floor: time_ms of an empty kernel "
          f"(torch.cuda._sleep(0)) {floor:.4f} ms", flush=True)
    for label, b, t, h, hd, n, per_path in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            def rand(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            # the ssm lowering's operands: stabilized dt and a, fan-in
            # scaled B, C and state
            ins = [u.to(dtype) for u in (
                rand(b, t, h, hd), rand(b, t, n) / n ** 0.5,
                rand(b, t, n) / n ** 0.5,
                0.05 + 0.2 * torch.sigmoid(rand(b, t, h)),
                -(0.1 + rand(h).abs()), rand(b, h, hd, n) / n ** 0.5)]
            sf, y = ssd_chunk_scan(*ins)
            sf_p, y_p = ssd_chunk_scan_plain(*ins)
            err = max(check(f"ssd_chunk_scan {label} {dtype} y", y, y_p,
                            KERNEL_RTOL[dtype]),
                      check(f"ssd_chunk_scan {label} {dtype} state", sf,
                            sf_p, KERNEL_RTOL[dtype]))
            plan = plan_call(*ins, sf)
            times = _times(lambda: ssd_chunk_scan(*ins),
                           lambda: ssd_chunk_scan_plain(*ins), None,
                           nbytes(*ins, y, sf), 6 * b * t * h * hd * n,
                           dtype, peaks)
            _report("ssd_chunk_scan", label, dtype, err, times,
                    f"B={b} T={t} H={h} hd={hd} N={n} [variant "
                    f"{plan.variant}, {plan.blocks} blocks of {plan.rows} "
                    f"rows, {plan.lanes} lanes per row, chunk {plan.chunk}]")
            tally.add(dtype, err, per_path, times)
            if t <= DECODE_T_MAX and dtype == torch.float32:
                # the chunk kernel on the same inputs, launched directly
                # (not counted), against the decode kernel's time
                length = min(CHUNK, t)
                chunked = SsdPlan(CHUNKED, 0, hd, b * h, length,
                                  smem_bytes(hd, n, length))
                y_c, sf_c = torch.empty_like(y), torch.empty_like(sf)
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


def _node_kind(spec) -> str:
    from repro_torch.kernels.winograd_conv.ops import winograd_eligible
    if spec.unit == "conv":
        return "winograd conv" if winograd_eligible(spec.op) else \
            "direct conv"
    if spec.op is None:
        return spec.unit
    return f"{spec.unit} ({spec.axis + ' split' if spec.coexec else 'one group'})"


def main_path(name: str, artifact: Path, make_input, out_shape,
              requests: int):
    """One main path: the artifact on two CUDA-stream groups, `requests`
    seeded inputs, each held against run_oracle, launch counts checked per
    request against the artifact; returns the launch counts (counters set
    to 0 just before the path, read just after), the compiled network, its
    float32 executor, the expected counts and each request's (input,
    output, oracle)."""
    import repro_torch

    t0 = time.perf_counter()
    compiled = repro_torch.CompiledNetwork.load(artifact)
    exe = compiled.executor(device="cuda")
    want = expected_counts(compiled.plan)
    print(f"{name}: loaded {artifact.name} (key {compiled.key}), weights on "
          f"{exe.device} in {time.perf_counter() - t0:.1f} s; groups "
          f"{len(exe.groups)}; per request the artifact gives {want}",
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
        if err > E2E_RTOL[name] * scale:
            raise AssertionError(f"{name} request {r}: max |run - "
                                 f"run_oracle| = {err:.3e} > "
                                 f"{E2E_RTOL[name]} x {scale:.3g}")
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
    return counts, compiled, exe, want, refs


def fused_path(name: str, exe, want: dict, refs: list) -> dict:
    """The fused segment walk of a main path: capture every fused segment
    as a CUDA graph, then run the per-node walk's requests again, each
    output bit-identical to that walk's and within E2E_RTOL of run_oracle,
    with the same launch, reshard and elided counts and one sync per
    segment; returns the launch counts (counters set to 0 just before the
    requests, read just after)."""
    from repro_torch.graph.ir import SEGMENT_FUSED

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
        if not err <= E2E_RTOL[name] * scale:
            raise AssertionError(f"{name} fused request {r}: max |run - "
                                 f"run_oracle| = {err:.3e} > "
                                 f"{E2E_RTOL[name]} x {scale:.3g}")
        for k in KERNEL_NAMES:
            if launched[k] != want[k]:
                raise AssertionError(f"{name} fused request {r}: "
                                     f"{launched[k]} {k} launches, want "
                                     f"{want[k]}")
        if (rep.reshard_points, rep.elided) != (want["reshard"],
                                                want["elided"]):
            raise AssertionError(
                f"{name} fused request {r}: {rep.reshard_points} reshard "
                f"points, {rep.elided} elided; want {want['reshard']} and "
                f"{want['elided']}")
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


def alternating_walls(name: str, exe, x, pairs: int) -> None:
    """Request walls of the per-node and fused walks on one input, run in
    turns (per-node, fused, per-node, fused, ...), so both see the same
    card and host state."""
    walls = {False: [], True: []}
    for _ in range(pairs):
        for fused in (False, True):
            t = time.perf_counter()
            exe.run(x, fused=fused)
            walls[fused].append((time.perf_counter() - t) * 1e3)
    node, fused = (sorted(walls[f]) for f in (False, True))
    print(f"{name} walls, {pairs} alternating pairs: per-node median "
          f"{statistics.median(node):.3f} ms (min {node[0]:.3f}, max "
          f"{node[-1]:.3f}); fused median {statistics.median(fused):.3f} ms "
          f"(min {fused[0]:.3f}, max {fused[-1]:.3f})", flush=True)


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


def image_input(size: int):
    """Seeded (1, size, size, 3) requests of a CNN path."""
    def make(r: int) -> np.ndarray:
        return np.random.default_rng(100 + r).standard_normal(
            (1, size, size, 3)).astype(np.float32)
    return make


vgg16_input = image_input(224)


def zamba_input(r: int) -> np.ndarray:
    return np.random.default_rng(300 + r).standard_normal(
        (1, 3584)).astype(np.float32)


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counters = kernel_counters()
    exe.run(x, fused=fused)
    before = {k: fn.launches for k, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(requests):
            exe.run(x, fused=fused)
        wall = (time.perf_counter() - t) * 1e3 / requests
    if fused:
        name = f"{name} fused"
    rows = sorted(((e.self_device_time_total / 1e3 / requests, e.count,
                    e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0.0:
        raise AssertionError(f"profile {name}: the trace holds no device "
                             f"time")
    # host calls that put work on the card: kernel launches, copies and
    # graph launches (the CUDA runtime's API events in the trace)
    calls = {}
    for e in prof.key_averages():
        if e.key.startswith(HOST_LAUNCH_CALLS):
            calls[e.key] = calls.get(e.key, 0) + e.count / requests
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
    graphs = sum(e.count for e in prof.key_averages()
                 if e.key == "cudaGraphLaunch")
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


#: the main paths: (name, committed artifact, request maker, output shape)
PATHS = [
    (VGG, ARTIFACT, vgg16_input, (1, 1000)),
    (ZAMBA, ZAMBA_ARTIFACT, zamba_input, (1, 3584)),
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

    # launch counts per walk: "<path>", "<path> fused", "<path> bf16", ...
    walks = {}
    for name, artifact, make_input, out_shape in PATHS:
        counts, compiled, exe, want, refs = main_path(
            name, artifact, make_input, out_shape, REQUESTS)
        walks[name] = counts
        device_breakdown(name, exe, make_input(REQUESTS))
        phases.done(f"{name} per-node")
        walks[f"{name} fused"] = fused_path(name, exe, want, refs)
        alternating_walls(name, exe, make_input(REQUESTS), WALL_PAIRS)
        device_breakdown(name, exe, make_input(REQUESTS), fused=True)
        phases.done(f"{name} fused")
        if name in BF16_PATHS:
            walks.update(bf16_path(name, compiled, want, refs))
            phases.done(f"{name} bf16")
        del compiled, exe, refs
        torch.cuda.empty_cache()
    for k in KERNEL_NAMES:
        for suffix in ("", " fused"):
            if sum(walks[f"{p[0]}{suffix}"][k] for p in PATHS) == 0:
                raise AssertionError(f"{k} was not launched on a main "
                                     f"path's{suffix or ' per-node'} walk")

    def by_path(name: str, t: Tally) -> dict:
        """Each walk's launches of kernel `name`, with the float32 times
        of one request where the walk is a float32 one."""
        out = {}
        for walk, counts in walks.items():
            path = walk.split(" ")[0]
            if not counts[name] and path not in t.by_path:
                continue
            out[walk] = {"launches": counts[name]}
            if "bf16" not in walk and path in t.by_path:
                out[walk].update(
                    {k: (None if k == "library_ms" and not t.library else v)
                     for k, v in t.by_path[path].items()})
        return out

    line = {"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": sum(c[name] for c in walks.values()),
        "max_abs_err": t.max_abs_err,
        "max_abs_err_bf16": t.max_abs_err_bf16,
        "ms": t.total("ms"), "plain_ms": t.total("plain_ms"),
        "bound_ms": t.total("bound_ms"),
        "bound_by": ("bytes" if t.total("t_bytes") >= t.total("t_ops")
                     else "operations"),
        "library_ms": t.total("library_ms"),
        "per": (f"launches: the {REQUESTS} requests of each main path's "
                f"per-node and fused walks and the {BF16_REQUESTS} of each "
                f"bf16 walk; times: one request of each main path, "
                f"float32"),
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
