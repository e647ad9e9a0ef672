"""`python -m repro_torch` — the port's CLI.

One subcommand so far:

  * `execute` — load a saved `repro.compiled_network` artifact (as the JAX
    package's `python -m repro plan --save` writes it) and run it end to
    end on a torch device, reporting executed-vs-predicted fidelity.

        python -m repro_torch execute --artifact PATH [--device cpu]
                                      [--per-op] [--runs N] [--fused]

    `--fused` also runs the segment walk (one CUDA graph per fused
    segment on the card) on the same input as the per-node walk, prints
    both walls and whether the outputs are bit-identical, and exits 1 if
    they are not.

The device defaults to CUDA; without CUDA the command fails unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


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
        report = compiled.profile(device=args.device)
        if args.per_op and i == args.runs - 1 and not args.fused:
            _print_per_op(report)
        print(f"  run {i + 1}/{args.runs}: {report.fidelity_summary()}")
    if args.fused:
        # both walks on the same input, outputs compared bit for bit
        x = exe.input_template()
        y_node = compiled.run(x, device=args.device, warmup=True)
        rep_node = compiled.last_report
        y_fused = compiled.run(x, device=args.device, warmup=True,
                               fused=True)
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
    p_exec.add_argument("--fused", action="store_true",
                        help="also run the segment walk (CUDA graphs) on "
                             "the same input; exit 1 unless its output is "
                             "bit-identical to the per-node walk's")
    args = ap.parse_args(argv)
    try:
        return _cmd_execute(args)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
