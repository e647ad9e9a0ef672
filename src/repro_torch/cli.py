"""`python -m repro_torch` — the port's CLI.

Two subcommands so far:

  * `execute` — load a saved `repro.compiled_network` artifact (as the JAX
    package's `python -m repro plan --save` writes it) and run it end to
    end on a torch device, reporting executed-vs-predicted fidelity.

        python -m repro_torch execute --artifact PATH [--device cpu]
                                      [--per-op] [--runs N] [--no-chain]
                                      [--no-warmup] [--fused]

    `--no-chain` gathers after every co-executed op (no elision);
    `--no-warmup` skips the untimed first pass.  `--fused` also runs the
    segment walk (one CUDA graph per fused segment on the card) on the
    same input as the per-node walk, prints both walls and whether the
    outputs are bit-identical, and exits 1 if they are not.

  * `verify` — statically verify plan documents and artifacts on disk
    with the port's verifier, never importing jax; exit 0 when clean, 1
    on any error diagnostic, 2 when there is nothing to verify.

        python -m repro_torch verify PATHS [--all-artifacts] [-v]

    `--all-artifacts` adds the port's committed artifacts
    (`src/repro_torch/artifacts/`) and the plan cache `reports/plans/`.

The device defaults to CUDA; without CUDA `execute` fails unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

#: the port's committed artifacts, scanned by `verify --all-artifacts`
ARTIFACTS_DIR = Path(__file__).resolve().parent / "artifacts"


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


def _cmd_verify(args) -> int:
    """Statically verify documents on disk; exit 1 on error diagnostics
    (warnings and info never fail the run), 2 when given nothing."""
    from repro_torch.analysis import (SEV_ERROR, SEV_INFO, SEV_WARNING,
                                      verify_path)
    paths = [Path(p) for p in args.paths]
    if args.all_artifacts:
        for d in (ARTIFACTS_DIR, Path("reports/plans")):
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
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Run compiled co-execution artifacts on PyTorch "
                    "devices.")
    sub = ap.add_subparsers(dest="cmd", required=True)
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
    p_verify = sub.add_parser(
        "verify", help="statically verify plan documents and artifacts "
                       "without importing jax or executing anything")
    p_verify.add_argument("paths", nargs="*",
                          help="plan or CompiledNetwork artifact JSON files "
                               "(dispatched by document shape)")
    p_verify.add_argument("--all-artifacts", action="store_true",
                          help="also scan src/repro_torch/artifacts and "
                               "reports/plans")
    p_verify.add_argument("-v", "--verbose", action="store_true",
                          help="also print info diagnostics (static "
                               "resource accounting)")
    args = ap.parse_args(argv)
    if args.cmd == "verify":
        return _cmd_verify(args)
    try:
        return _cmd_execute(args)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
