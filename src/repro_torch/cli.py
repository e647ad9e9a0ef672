"""`python -m repro_torch` — the port's CLI.

Seven subcommands so far:

  * `plan` — compile (or fetch from the plan cache) a co-execution plan
    with the port's planning half, as `python -m repro plan` does, with
    its options; `--out` also writes the plan JSON, `--save` the
    shippable artifact (byte-identical to the reference's for the same
    options), `--explain` prints the per-node decision table.

        python -m repro_torch plan --network vgg16 --device moto2022
                                   --threads 3 --save vgg16.coexec.json
        python -m repro_torch plan --model zamba2-7b --blocks 9
                                   --cache-len 4096 --threads 1 --save X

    `--tune` (on the card) runs the Hopper launch autotuner on a
    plan-cache miss and saves the tuned launches beside the artifact
    (`<stem>.hopper_tiles.json`); `--tune-cache-dir` names its tune cache.

  * `tune` — time every candidate launch of every unique op of a network
    on the card and store the winners in the tune cache, with the
    reference's flags (`--reps`, `--tune-cache-dir`); warm entries are
    returned without measuring.

        python -m repro_torch tune --network vgg16 [--reps 2]
                                   [--tune-cache-dir reports/tune]

    Without CUDA, `tune` and `plan --tune` exit 2 naming CUDA: nothing is
    timed on the CPU in their place.

  * `execute` — load a saved `repro.compiled_network` artifact (as `plan
    --save` in either package writes it) and run it end to end on a
    torch device, reporting executed-vs-predicted fidelity.

        python -m repro_torch execute --artifact PATH [--device cpu]
                                      [--per-op] [--runs N] [--no-chain]
                                      [--no-warmup] [--fused]

    `--no-chain` gathers after every co-executed op (no elision);
    `--no-warmup` skips the untimed first pass.  `--fused` also runs the
    segment walk (one CUDA graph per captured segment on the card) on the
    same input as the per-node walk, prints both walls and whether the
    outputs are bit-identical, and exits 1 if they are not.

  * `calibrate` — compile (as `plan` does), record `--runs` executions
    into the measurement store, fit a latency calibrator, replan with the
    corrected predictors and print the plan diff, with the reference's
    flags and output lines.  `--torch-device` names the torch device the
    executions run on (`--device` is the simulated phone).

        python -m repro_torch calibrate --network vgg16 --threads 3
                                        [--runs 2] [--store-dir DIR]
                                        [--save-calibration PATH]
                                        [--torch-device cpu]

  * `verify` — statically verify plan documents, artifacts and plan
    portfolios on disk with the port's verifier, never importing jax;
    exit 0 when clean, 1 on any error diagnostic, 2 when there is nothing
    to verify.

        python -m repro_torch verify PATHS [--all-artifacts] [-v]

    `--all-artifacts` adds the port's committed artifacts
    (`src/repro_torch/artifacts/`), the plan cache `reports/plans/` and
    the tune cache `reports/tune/`; a tuned artifact's sidecar verifies
    with it.

  * `lint` — run the port's repo-contract linter
    (`repro_torch/analysis/lint.py`) over the port's package, or the
    package directory `--src` names, with the reference's rule ids; print
    each finding and a count, exit 1 on any finding.

        python -m repro_torch lint [--src DIR]

  * `serve` — serve seeded requests with a model of the registry: a
    fixed batch through the `ServingEngine` (optionally shipping a
    `--compiled` artifact, executed once after serving), or Poisson
    traffic through the `ContinuousScheduler` over a plan portfolio
    (`--arrivals poisson --portfolio PATH`), with the reference's flags
    (`repro_torch/launch/serve.py`).

        python -m repro_torch serve --arch codeqwen15_7b [--reduced]
                                    [--arrivals poisson --portfolio P]
                                    [--torch-device cpu]
        python -m repro_torch serve --arch zamba2_7b [--reduced]
                                    [--torch-device cpu]
        python -m repro_torch serve --arch rwkv6_1b6 [--reduced]
                                    [--torch-device cpu]

        python -m repro_torch serve --arch whisper_large_v3 [--reduced]
                                    [--torch-device cpu]

    Zamba2, RWKV6 and Whisper serve through the fixed batch only: the
    scheduler refuses them (exit 2).

  * `train` — train a model of the registry on the synthetic stream with
    AdamW, with the reference's flags (`repro_torch/launch/train.py`).

        python -m repro_torch train --arch rwkv6_1b6 [--reduced]
                                    [--steps N --batch B --seq T]
                                    [--checkpoint-dir D] [--torch-device cpu]

Executions run on CUDA by default; without CUDA `execute`, `calibrate`,
`serve` and `train` fail unless `--device cpu` (`execute`) or
`--torch-device cpu` (`calibrate`, `serve`, `train`) is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

#: the port's committed artifacts, scanned by `verify --all-artifacts`
ARTIFACTS_DIR = Path(__file__).resolve().parent / "artifacts"


def _add_compile_args(ap: argparse.ArgumentParser) -> None:
    from repro_torch.core.simulator.devices import DEVICES
    from repro_torch.core.sync import SyncMechanism

    # no choices= here: unknown names surface compile's ValueError, which
    # lists both registries (unit networks + model graphs) in one message
    ap.add_argument("--network", default="resnet18",
                    help="unit network (vgg16, resnet18, ...) or any name "
                         "--model accepts")
    ap.add_argument("--model", default=None,
                    help="decoder-block model graph via graph.from_model "
                         "(tiny_decoder, tiny_ssm, zamba2-7b, ...); "
                         "overrides --network")
    ap.add_argument("--cache-len", type=int, default=128,
                    help="KV-cache length of --model attention nodes")
    ap.add_argument("--tokens", type=int, default=1,
                    help="tokens per decode step of --model graphs "
                         "(chunked prefill; pure-SSM configs only)")
    ap.add_argument("--blocks", type=int, default=1,
                    help="decoder blocks to chain for --model graphs")
    ap.add_argument("--device", default="moto2022", choices=sorted(DEVICES),
                    help="the simulated phone to plan for")
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--mechanism", default="svm_poll",
                    choices=[m.value for m in SyncMechanism])
    ap.add_argument("--step", type=int, default=8,
                    help="candidate-grid step (channels)")
    ap.add_argument("--mode", default="predicted",
                    choices=["predicted", "grid"],
                    help="predicted = GBDT planning (deployable); "
                         "grid = measurement-driven oracle")
    ap.add_argument("--cache-dir", default="reports/plans",
                    help="on-disk PlanCache directory (shared with the "
                         "reference: the same keys and files)")
    ap.add_argument("--samples", type=int, default=400,
                    help="training ops per predictor (simulator-measured)")
    ap.add_argument("--estimators", type=int, default=60,
                    help="GBDT trees per predictor")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--predictor-cache", default=None,
                    help="optional directory to cache trained predictors "
                         "(a load is checksum-identical to a retrain)")
    ap.add_argument("--tune", action="store_true",
                    help="autotune the Hopper kernels' launches on the card "
                         "on a plan-cache miss and run the plan with the "
                         "winners (tuned plans get their own cache "
                         "entries; needs CUDA)")
    ap.add_argument("--tune-cache-dir", default="reports/tune",
                    help="on-disk TuneCache directory (measured launch "
                         "choices, content-addressed)")


class _UserInputError(Exception):
    """A bad CLI input (unknown name, invalid target, ...), printed as one
    line; internal failures keep their tracebacks."""


def _network_arg(args):
    """The compile() input: model names, via --model or --network, build
    a decoder-block graph with the CLI's blocks/cache-len/tokens knobs;
    everything else resolves by name inside `compile`."""
    name = args.model or args.network
    if args.model or _is_model_name(name):
        from repro_torch.graph.frontends import from_model
        return from_model(name, blocks=args.blocks,
                          cache_len=args.cache_len, tokens=args.tokens)
    return name


def _is_model_name(name: str) -> bool:
    from repro_torch.core.networks import NETWORKS
    if name in NETWORKS:
        return False
    from repro_torch.graph.frontends import model_names
    return name in model_names()


def _compile(args):
    from repro_torch.api import Target, compile as _api_compile
    t0 = time.time()
    # ValueErrors up to and including compile() are user-input problems
    # (unknown name/device/mechanism, predictor/target mismatch), and so
    # is --tune on a host without CUDA
    try:
        target = Target(device=args.device, threads=args.threads,
                        mechanism=args.mechanism, step=args.step,
                        seed=args.seed)
        network = _network_arg(args)
        if args.tune:
            _tune_device()
        compiled = _api_compile(network, target, mode=args.mode,
                                cache=args.cache_dir, samples=args.samples,
                                estimators=args.estimators,
                                predictor_cache=args.predictor_cache,
                                tune=args.tune,
                                tune_cache=args.tune_cache_dir)
    except ValueError as e:
        raise _UserInputError(str(e)) from e
    return compiled, time.time() - t0


def _tune_device():
    """The card the tuner measures; a host without CUDA is a clean
    one-line error."""
    from repro_torch.runtime.autotune import measure_device
    try:
        return measure_device()
    except RuntimeError as e:
        raise _UserInputError(str(e)) from e


def _cmd_tune(args) -> int:
    """Measured launch search for every unique op of a network, through
    the on-disk TuneCache (warm entries are returned without measuring)."""
    from repro_torch.api import _resolve_graph
    from repro_torch.kernels import registry, tiles
    from repro_torch.runtime.autotune import (TuneCache, autotune,
                                              tune_cache_version)
    try:
        graph_or_ops, is_graph = _resolve_graph(_network_arg(args))
    except ValueError as e:
        raise _UserInputError(str(e)) from e
    device, backend = _tune_device()
    ops = ([n.op for n in graph_or_ops if n.op is not None] if is_graph
           else list(graph_or_ops))
    unique = list(dict.fromkeys(ops))
    cache = TuneCache(Path(args.tune_cache_dir))
    print(f"tune {args.model or args.network}: {len(unique)} unique ops on "
          f"{device}/{backend} ({tune_cache_version()}) -> {cache.root}")
    tuned = 0
    for op in unique:
        extents = registry.launch_extents(op)
        n_cand = len(tiles.launch_spec(registry.op_kind(op))
                     .configs(extents))
        t0 = time.time()
        hits = cache.hits
        best = autotune(op, cache=cache, device=device, backend=backend,
                        reps=args.reps)
        if best.is_default:
            verdict = "default"
        else:
            tuned += 1
            verdict = f"default -> {best.label()}"
        src = ("cache" if cache.hits > hits
               else f"measured {n_cand} candidates" if extents
               else "launches no kernel of the port")
        print(f"  {registry.op_label(op):42s} {verdict:28s} "
              f"({src}, {time.time() - t0:.1f}s)")
    print(f"  {tuned}/{len(unique)} ops tuned away from the default "
          f"launch ({cache.hits} cache hits)")
    return 0


def _cache_status(compiled) -> str:
    return "HIT" if compiled.from_cache else "MISS (compiled)"


def _cmd_plan(args) -> int:
    from repro_torch.runtime.cache import PlanCache
    compiled, dt = _compile(args)
    plan = compiled.plan
    n_co = sum(1 for d in plan.decisions if not d.exclusive)
    name = args.model or args.network
    print(f"plan {name} on {args.device} (cpu{args.threads}, "
          f"{args.mechanism}, {args.mode}): cache {_cache_status(compiled)}")
    print(f"  compiled in {dt:.1f}s (predictors + planning; a warm hit is "
          f"a pure JSON read)")
    print(f"  key {plan.key} -> "
          f"{PlanCache(Path(args.cache_dir)).path_for(plan.provenance)}")
    if plan.end_to_end_us is not None:
        print(f"  baseline (GPU only): {plan.baseline_us / 1e3:.1f} ms | "
              f"end-to-end co-exec: {plan.end_to_end_us / 1e3:.1f} ms "
              f"({plan.baseline_us / plan.end_to_end_us:.2f}x)")
    print(f"  {n_co}/{len(plan.decisions)} ops co-executed")
    # write the files before the explain dump: a consumer closing the pipe
    # early (`... | head`) must not skip the requested writes
    if args.out:
        plan.save(Path(args.out))
        print(f"  wrote plan {args.out}")
    if args.save:
        compiled.save(args.save)
        print(f"  wrote artifact {args.save}")
    if args.explain:
        print(compiled.explain())
    if args.verbose:
        from repro_torch.analysis import rejections
        print(f"  {rejections.summary()}")
        for digest, rule, detail in rejections.entries():
            why = f": {detail}" if detail else ""
            print(f"    {digest} rejected by {rule}{why}")
    return 0


def _cmd_execute(args) -> int:
    import torch

    from repro_torch.api import CompiledNetwork

    compiled = CompiledNetwork.load(args.artifact)
    print(f"execute artifact {args.artifact} (compiled for "
          f"{compiled.target.device}, key {compiled.key})")
    exe = compiled.executor(device=args.device)
    groups = ("2 co-execution groups" if exe.split_capable
              else "1 group (exclusive execution)")
    print(f"  on {exe.device}: {groups}")
    for i in range(args.runs):
        report = compiled.profile(device=args.device,
                                  chain=not args.no_chain,
                                  warmup=not args.no_warmup)
        if args.per_op and i == args.runs - 1 and not args.fused:
            _print_per_op(report)
        print(f"  run {i + 1}/{args.runs}: {report.fidelity_summary()}")
    if args.fused:
        # both walks on the same input, outputs compared bit for bit
        x = exe.input_template()
        y_node = compiled.run(x, device=args.device,
                              warmup=not args.no_warmup)
        rep_node = compiled.last_report
        y_fused = compiled.run(x, device=args.device,
                               warmup=not args.no_warmup, fused=True)
        rep_fused = compiled.last_report
        identical = torch.equal(y_fused, y_node)
        print(f"  fused: {len(rep_fused.segment_wall_us)} segments, "
              f"{rep_fused.sync_points} syncs (vs {rep_node.sync_points} "
              f"unfused), outputs "
              f"{'bit-identical' if identical else 'DIVERGED'}")
        print(f"  fused wall {rep_fused.wall_us / 1e3:.3f} ms vs unfused "
              f"{rep_node.wall_us / 1e3:.3f} ms")
        if args.per_op:
            _print_per_op(rep_fused)
        print(f"  fused: {rep_fused.fidelity_summary()}")
        if not identical:
            return 1
    return 0


def _cmd_calibrate(args) -> int:
    from repro_torch.measure import MeasurementStore, fidelity_error
    from repro_torch.runtime.cache import PlanCache

    if args.mode != "predicted":
        print("error: calibrate needs mode='predicted' (grid plans are "
              "measurement-driven; there are no predictors to calibrate)",
              file=sys.stderr)
        return 2
    compiled, dt = _compile(args)
    print(f"calibrate {args.model or args.network} on {args.device} "
          f"(cpu{args.threads}, {args.mechanism}): plan {compiled.key} "
          f"(cache {_cache_status(compiled)}, {dt:.1f}s)")
    store = MeasurementStore(Path(args.store_dir))
    for i in range(args.runs):
        rep = compiled.record(store=store, device=args.torch_device,
                              warmup=not args.no_warmup)
        print(f"  run {i + 1}/{args.runs}: {rep.fidelity_summary()}")
    records = store.load(compiled.key)
    cal = compiled.recalibrate(store)
    pre = fidelity_error(records)
    post = cal.fidelity_error(records)
    print(f"  {cal.summary()}" if args.verbose else
          f"  calibrator {cal.version}: {len(cal.corrections)} corrections "
          f"from {cal.n_records} records")
    shrink = f" ({pre / post:.1f}x smaller)" if post > 0 else ""
    print(f"  fidelity error {pre:.2f} -> {post:.2f} "
          f"(sum |log wall/pred| over {cal.n_records} usable records)"
          f"{shrink}")
    if args.save_calibration:
        path = cal.save(Path(args.save_calibration))
        print(f"  wrote calibrator {path}")
    recompiled, diff = compiled.replan(cal, store=store,
                                       cache=args.cache_dir)
    print(diff.summary())
    print(f"  new plan cached at "
          f"{PlanCache(Path(args.cache_dir)).path_for(recompiled.provenance)}")
    print(f"  measurements {store.path_for(compiled.key)} "
          f"({len(records)} records)")
    return 0


def _cmd_verify(args) -> int:
    """Statically verify documents on disk; exit 1 on error diagnostics
    (warnings and info never fail the run), 2 when given nothing."""
    from repro_torch.analysis import (SEV_ERROR, SEV_INFO, SEV_WARNING,
                                      verify_path)
    paths = [Path(p) for p in args.paths]
    if args.all_artifacts:
        for d in (ARTIFACTS_DIR, Path("reports/plans"),
                  Path("reports/tune")):
            paths.extend(sorted(d.glob("*.json")))
    if not paths:
        print("error: nothing to verify (pass artifact paths or "
              "--all-artifacts)", file=sys.stderr)
        return 2
    n_err = n_warn = 0
    for p in paths:
        kind, diags = verify_path(p, stats=args.verbose)
        errs = [d for d in diags if d.severity == SEV_ERROR]
        warns = [d for d in diags if d.severity == SEV_WARNING]
        n_err += len(errs)
        n_warn += len(warns)
        print(f"{'FAIL' if errs else 'ok':4s} {kind:9s} {p}")
        shown = errs + warns
        if args.verbose:
            shown += [d for d in diags if d.severity == SEV_INFO]
        for d in shown:
            print(f"       {d}")
    print(f"verified {len(paths)} artifact(s): {n_err} error(s), "
          f"{n_warn} warning(s)")
    return 1 if n_err else 0


def _cmd_lint(args) -> int:
    """Run the repo-contract linter; exit 1 on any finding."""
    from repro_torch.analysis.lint import LINT_RULES, lint_repo, package_root
    pkg = Path(args.src) if args.src else package_root()
    diags = lint_repo(pkg)
    for d in diags:
        print(d)
    rules = ", ".join(sorted(LINT_RULES))
    print(f"lint {pkg}: {len(diags)} finding(s) across [{rules}]")
    return 1 if diags else 0


def _print_per_op(report) -> None:
    for t in report.timings:
        extra = " chained" if t.chained_input else ""
        if t.segment >= 0:
            extra += f" seg={t.segment}"
        print(f"  [{t.index:02d}] {t.label:42s} {t.mode:9s} "
              f"{t.c_fast}/{t.c_slow} wall {t.wall_us:9.0f}us "
              f"pred {t.pred_us:8.1f}us{extra}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # serve and train forward their whole tail to their own parsers;
    # dispatch before argparse so leading options (`serve --arch ...`)
    # survive
    if argv[:1] == ["serve"]:
        from repro_torch.launch.serve import serve_main
        return serve_main(argv[1:])
    if argv[:1] == ["train"]:
        from repro_torch.launch.train import train_main
        return train_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Compile co-execution plans and run them on PyTorch "
                    "devices.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_plan = sub.add_parser(
        "plan", help="compile (or fetch from cache) a co-execution plan")
    _add_compile_args(p_plan)
    p_plan.add_argument("--out", default=None,
                        help="also write the plan JSON to this path")
    p_plan.add_argument("--save", default=None,
                        help="write the shippable CompiledNetwork artifact "
                             "(plan + target + checksum) to this path")
    p_plan.add_argument("--explain", action="store_true",
                        help="print the per-op decision table")
    p_plan.add_argument("-v", "--verbose", action="store_true",
                        help="also print cache-rejection counts (which "
                             "verifier rule each stale entry failed)")
    p_exec = sub.add_parser(
        "execute", help="execute a saved CompiledNetwork artifact end to "
                        "end and report executed-vs-predicted fidelity")
    p_exec.add_argument("--artifact", required=True,
                        help="a repro.compiled_network JSON artifact")
    p_exec.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda)")
    p_exec.add_argument("--runs", type=int, default=1,
                        help="timed executions to report")
    p_exec.add_argument("--per-op", action="store_true",
                        help="print one line per executed unit")
    p_exec.add_argument("--no-chain", action="store_true",
                        help="gather after every co-executed op "
                             "(no elision)")
    p_exec.add_argument("--no-warmup", action="store_true",
                        help="skip the untimed warmup pass (timings then "
                             "include kernel builds and graph captures)")
    p_exec.add_argument("--fused", action="store_true",
                        help="also run the segment walk (CUDA graphs) on "
                             "the same input; exit 1 unless its output is "
                             "bit-identical to the per-node walk's")
    p_cal = sub.add_parser(
        "calibrate", help="record executions, fit a latency calibrator, "
                          "replan with corrected predictors, and show the "
                          "plan diff")
    _add_compile_args(p_cal)
    p_cal.add_argument("--runs", type=int, default=2,
                       help="timed executions to record before fitting")
    p_cal.add_argument("--store-dir", default="reports/measurements",
                       help="measurement store directory (append-only "
                            "JSONL per plan)")
    p_cal.add_argument("--save-calibration", default=None,
                       help="also write the fitted calibrator JSON here")
    p_cal.add_argument("--no-warmup", action="store_true",
                       help="skip the untimed warmup before the first "
                            "recorded run")
    p_cal.add_argument("--verbose", action="store_true",
                       help="print per-(kind, mode) correction lines")
    p_cal.add_argument("--torch-device", default=None,
                       help="torch device the recorded executions run on "
                            "(default: cuda)")
    p_tune = sub.add_parser(
        "tune", help="autotune the Hopper kernels' launches for a "
                     "network's ops on the card and store the winners in "
                     "the on-disk TuneCache")
    _add_compile_args(p_tune)
    p_tune.add_argument("--reps", type=int, default=2,
                        help="timed repetitions per candidate (median)")
    p_verify = sub.add_parser(
        "verify", help="statically verify plan documents, artifacts and "
                       "plan portfolios without importing jax or "
                       "executing anything")
    p_verify.add_argument("paths", nargs="*",
                          help="plan, CompiledNetwork artifact, plan "
                               "portfolio or tune entry JSON files, or a "
                               "tuned artifact's sidecar (dispatched by "
                               "document shape)")
    p_verify.add_argument("--all-artifacts", action="store_true",
                          help="also scan src/repro_torch/artifacts, "
                               "reports/plans and reports/tune")
    p_verify.add_argument("-v", "--verbose", action="store_true",
                          help="also print info diagnostics (static "
                               "resource accounting)")
    p_lint = sub.add_parser(
        "lint", help="run the repo-contract linter (import-light, "
                     "registry completeness, no-silent-clamp)")
    p_lint.add_argument("--src", default=None,
                        help="package directory to lint (default: the "
                             "repro_torch package)")
    args = ap.parse_args(argv)
    if args.cmd == "verify":
        return _cmd_verify(args)
    if args.cmd == "lint":
        return _cmd_lint(args)
    if args.cmd in ("plan", "calibrate", "tune"):
        cmd = {"plan": _cmd_plan, "calibrate": _cmd_calibrate,
               "tune": _cmd_tune}[args.cmd]
        try:
            return cmd(args)
        except _UserInputError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        return _cmd_execute(args)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
