"""`python -m repro_torch serve`: batched requests through the
`ServingEngine`, or Poisson traffic through the continuous scheduler.

The port's counterpart of `repro.launch.serve`, with its flags plus
`--torch-device` (the torch device the model and the plans run on: CUDA
unless `--torch-device cpu`; without CUDA and without that flag the
command fails, it never carries on on the CPU).  `--device` stays the
simulated phone a portfolio is compiled for.

Fixed-batch mode (a dense transformer, the Zamba2 hybrid
`--arch zamba2_7b`, RWKV6 `--arch rwkv6_1b6`, or Whisper
`--arch whisper_large_v3`, each request with seeded frames):

    python -m repro_torch serve --arch codeqwen15_7b --requests 8 \
        --max-new 12 [--compiled ARTIFACT] [--reduced --torch-device cpu]

Continuous-batching mode (`--arrivals poisson`; the scheduler refuses a
model without per-slot positions, such as Zamba2, RWKV6 and Whisper, and
the command exits 2 with its message):

    python -m repro_torch serve --arch codeqwen15_7b --arrivals poisson \
        --rate 200 --requests 50 --portfolio reports/portfolio.json

`--portfolio <path>` loads the portfolio document if it exists and
otherwise compiles one there (`repro_torch.compile_portfolio`; a loaded
document serves but cannot replan: it carries no predictors).
`--throttle-at`/`--throttle-scale` simulate a mid-run slowdown of the
recorded plan walls, exercising the drift-triggered in-place replan.
`--compiled <artifact>` ships a saved `CompiledNetwork` with the engine
and executes it once after serving, printing its fidelity summary.

The weights are seeded draws (seed 0, made on the serving device), at
the architecture's published widths unless `--reduced`; `--seed` seeds
the traffic and the sampling.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models import ARCH_IDS, build_model, get_config
from repro_torch.serving import Request, ServingEngine


def _parse_buckets(text: str):
    """"1x64,4x64,4x256" -> ((1, 64), (4, 64), (4, 256))."""
    out = []
    for part in text.split(","):
        b, _, s = part.strip().partition("x")
        out.append((int(b), int(s)))
    return tuple(out)


def _load_or_compile_portfolio(args, cfg):
    import repro_torch

    path = Path(args.portfolio)
    if path.exists():
        pf = repro_torch.PlanPortfolio.load(path)
        note = "" if pf.can_replan() else \
            " (loaded artifact: serves, cannot replan)"
        print(f"portfolio {path}: {pf}{note}")
        return pf
    buckets = _parse_buckets(args.buckets)
    print(f"compiling portfolio for {cfg.name} on {args.device} "
          f"(buckets {args.buckets}) ...")
    pf = repro_torch.compile_portfolio(
        cfg, repro_torch.Target(device=args.device), buckets=buckets,
        cache=args.cache_dir, samples=args.samples,
        estimators=args.estimators)
    pf.save(path)
    print(f"  wrote {path}: {pf}")
    return pf


def _where(device: torch.device) -> str:
    """The serving device as a throughput line names it."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _serve_scheduler(args, cfg, model, params, device) -> int:
    from repro_torch.serving import (ContinuousScheduler, SchedulerConfig,
                                     ThrottleSim, poisson_requests)

    portfolio = None
    if args.portfolio:
        portfolio = _load_or_compile_portfolio(args, cfg)
    throttle = None
    if args.throttle_at is not None:
        throttle = ThrottleSim(at_s=args.throttle_at,
                               scale=args.throttle_scale)
        print(f"simulating throttle: x{args.throttle_scale} wall time "
              f"from t={args.throttle_at}s")
    store = args.store_dir if portfolio is not None else None
    try:
        sched = ContinuousScheduler(
            cfg, model, params, portfolio=portfolio, measurement_store=store,
            throttle=throttle, plan_cache=args.cache_dir, device=device,
            config=SchedulerConfig(max_batch=args.max_batch,
                                   max_len=args.max_len,
                                   fidelity_every=args.fidelity_every))
    except ValueError as e:           # the scheduler refuses the model
        print(f"error: {e}", file=sys.stderr)
        return 2
    reqs = poisson_requests(args.requests, rate=args.rate,
                            vocab_size=cfg.vocab_size,
                            max_new=(args.max_new // 2 or 1, args.max_new),
                            seed=args.seed)
    t0 = time.time()
    report = sched.run(reqs)
    dt = time.time() - t0
    for c in report.completions[:4]:
        print(f"req {c.rid}: {c.tokens}")
    print(report.summary())
    print(f"(host wall {dt:.1f}s, {report.total_tokens / dt:.1f} tok/s "
          f"on {_where(device)})")
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch serve")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--compiled", default=None,
                    help="CompiledNetwork artifact to ship with the engine "
                         "(executed once after serving; see `python -m "
                         "repro_torch plan --save`)")
    ap.add_argument("--arrivals", default="batch",
                    choices=["batch", "poisson"],
                    help="batch = fixed-batch ServingEngine; poisson = "
                         "continuous scheduler over Poisson traffic")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate, requests/s (scheduler "
                         "virtual clock)")
    ap.add_argument("--portfolio", default=None,
                    help="plan-portfolio artifact path: loaded if present, "
                         "else compiled there (scheduler mode)")
    ap.add_argument("--buckets", default="1x64,4x64",
                    help="portfolio (batch x seq) buckets, e.g. "
                         "'1x64,4x64,4x256'")
    ap.add_argument("--device", default="moto2022",
                    help="simulated target device for portfolio compilation")
    ap.add_argument("--cache-dir", default="reports/plans",
                    help="plan cache directory (portfolio compilation and "
                         "in-place replans)")
    ap.add_argument("--store-dir", default="reports/measurements",
                    help="measurement store for per-bucket fidelity records")
    ap.add_argument("--max-len", type=int, default=128,
                    help="per-slot cache length (scheduler mode)")
    ap.add_argument("--fidelity-every", type=int, default=16,
                    help="plan-execution cadence in scheduler steps")
    ap.add_argument("--throttle-at", type=float, default=None,
                    help="simulate a thermal throttle from this time (s) on "
                         "the scheduler clock")
    ap.add_argument("--throttle-scale", type=float, default=1.8,
                    help="wall-time multiplier of the simulated throttle")
    ap.add_argument("--samples", type=int, default=400,
                    help="predictor training ops (portfolio compilation)")
    ap.add_argument("--estimators", type=int, default=60,
                    help="GBDT trees per predictor (portfolio compilation)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torch-device", default=None,
                    help="torch device the model and the plans run on "
                         "(default: cuda)")
    return ap


def serve_main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.core.coexec import resolve_device

    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.torch_device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    if args.arrivals == "poisson":
        return _serve_scheduler(args, cfg, model, params, device)

    compiled = None
    if args.compiled:
        from repro_torch.api import CompiledNetwork
        compiled = CompiledNetwork.load(args.compiled)
        print(f"shipping compiled plan {compiled.key} "
              f"(device {compiled.target.device})")

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 17)).astype(np.int32)
        frames = None
        if cfg.is_encoder_decoder:
            # drawn between prompts, as the reference draws them
            frames = rng.normal(size=(cfg.encoder_seq, cfg.d_model)
                                ).astype(np.float32) * 0.02
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new_tokens=args.max_new,
                            temperature=args.temperature, frames=frames))

    engine = ServingEngine(cfg, model, params, max_batch=args.max_batch,
                           max_len=64 + args.max_new, compiled=compiled,
                           seed=args.seed, device=device)
    t0 = time.time()
    completions = engine.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in completions)
    for c in completions[:4]:
        print(f"req {c.rid}: {c.tokens}")
    print(f"{len(completions)} completions, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens / dt:.1f} tok/s on "
          f"{_where(device)})")

    if compiled is not None:
        _, report = engine.execute_plan()
        print(report.fidelity_summary())
    return 0
