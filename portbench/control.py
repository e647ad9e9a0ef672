"""Readings for the limits: the program's compared numbers and its
control's, over many seeds in one process.

    python3 -m portbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

For each seed: the seed's weights and inputs, warm-up, a closed loop of
`--seconds` at the cell's own load (long enough to finish the mix's
longest calls and to hold as many as a run does), then the check: the
program's numbers, and with `--control` the control's (the reference in
the nearest precision below the configuration's, in the program's place,
on the same inputs).  One JSON line per seed.  The benchmark's own runs
never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from portbench import run
    run.prepare_process()
    import torch

    from portbench import manifest, traffic

    cell = manifest.cell(manifest.load(), args.workload)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    config = manifest.config(cell["config"])
    mix = traffic.mix(manifest.traffic(cell["traffic"]))
    run.set_tf32(config)
    drv = manifest.driver(config["driver"]).Driver(config, mix, "cuda")
    for seed in args.seeds:
        drv.prepare(seed)
        drv.warmup()
        torch.cuda.synchronize()
        calls = run.window(drv, args.seconds, torch.cuda.synchronize)
        line = {"seed": seed, "calls": len(calls),
                "failed": sum(c.failed for c in calls),
                "program": drv.check()}
        if args.control:
            line["control"] = drv.check(control=True)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
