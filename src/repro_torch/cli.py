"""`python -m repro_torch` — the port's CLI.

One subcommand so far:

  * `execute` — load a saved `repro.compiled_network` artifact (as the JAX
    package's `python -m repro plan --save` writes it) and run it end to
    end on a torch device, reporting executed-vs-predicted fidelity.

        python -m repro_torch execute --artifact PATH [--device cpu]
                                      [--per-op] [--runs N]

The device defaults to CUDA; without CUDA the command fails unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def _cmd_execute(args) -> int:
    from repro_torch.api import CompiledNetwork

    compiled = CompiledNetwork.load(args.artifact)
    print(f"execute artifact {args.artifact} (compiled for "
          f"{compiled.target.device}, key {compiled.key})")
    exe = compiled.executor(device=args.device)
    groups = ("2 co-execution groups" if exe.split_capable
              else "1 group (exclusive execution)")
    print(f"  on {exe.device}: {groups}")
    for i in range(args.runs):
        report = compiled.profile(device=args.device)
        if args.per_op and i == args.runs - 1:
            for t in report.timings:
                extra = " chained" if t.chained_input else ""
                print(f"  [{t.index:02d}] {t.label:42s} {t.mode:9s} "
                      f"{t.c_fast}/{t.c_slow} wall {t.wall_us:9.0f}us "
                      f"pred {t.pred_us:8.1f}us{extra}")
        print(f"  run {i + 1}/{args.runs}: {report.fidelity_summary()}")
    return 0


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
    args = ap.parse_args(argv)
    try:
        return _cmd_execute(args)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
