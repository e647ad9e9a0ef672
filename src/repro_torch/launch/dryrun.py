"""Dry run: walk every (architecture x input shape) step at its published
widths on a device mesh, with no device memory: the port's counterpart
of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_405b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun     # every combination

The reference lowers and compiles each step for a 256- or 512-device
mesh of virtual devices and reads XLA's memory and cost analyses.  The
port has no compiler to ask, so it builds every input as a fake tensor
(`launch.steps.input_specs`: shapes and dtypes, no memory), runs the step
on them in eager PyTorch and counts its op stream (`roofline.op_walk`),
then writes the reference's record, with `walk_s` in place of `lower_s`
and `compile_s`, to `reports/dryrun_torch/<arch>_<shape>_<mesh>.json`.
Nothing here sets an environment variable.

What the record's numbers are:
  * `hlo_flops`, `hlo_bytes`: the walk's FLOPs and bytes of the global
    program (the reference's are one device's program times the device
    count, which also counts work its partitioner replicates); bytes are
    eager PyTorch's, each op's inputs and outputs, with nothing fused;
  * `collective_bytes`, `t_collective_s`: 0 on a one-device mesh (the
    program issues no collective); on a larger mesh null: the port has
    no partitioner to say what would move, and `bottleneck` is chosen
    from the terms that were counted;
  * `peak_memory_bytes`: one device's arguments and outputs, which the
    shardings give exactly (each leaf's bytes over the product of its
    spec's axis sizes), plus an estimate of its intermediates: the
    walk's peak of live intermediate bytes over the batch shards;
  * a Mamba2 model's SSD scans are counted as `ssd_chunk_scan`'s plain
    version (fake CPU tensors take its CPU branch), and the record says
    so under `counted_as_plain`.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import List, Optional, Sequence

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.shapes import INPUT_SHAPES, shape_applicable
from repro_torch.launch.steps import (input_specs, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import ARCH_IDS, build
from repro_torch.optim.adamw import AdamWState
from repro_torch.roofline.analysis import build_report
from repro_torch.roofline.op_walk import analyze
from repro_torch.sharding.ctx import activation_mesh
from repro_torch.sharding.rules import (batch_shardings, batch_spec,
                                        cache_shardings, param_shardings,
                                        replicated, shard_bytes)

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"


def _bytes(tree, shardings) -> int:
    """One device's bytes of `tree` under its congruent `shardings`."""
    return sum(shard_bytes(leaf, sh) for leaf, sh in
               zip(tree_leaves(tree), tree_leaves(shardings)))


def _write(rec: dict, report_dir: Path, tag: str = "") -> None:
    report_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json"
    with open(report_dir / name, "w") as f:
        json.dump(rec, f, indent=1)


def counted_as_plain(cfg) -> list:
    """The kernels a walk of `cfg`'s step counts as their plain versions
    (fake CPU tensors take each one's CPU branch)."""
    return ["ssd_chunk_scan"] if cfg.ssm_kind == "mamba2" else []


def walk_step(cfg, model, shape, mesh):
    """Walk `model`'s step for `shape` (an `InputShape`) on fake inputs
    under `mesh`: (the walk's `CompCost`, one device's argument bytes,
    one device's output bytes, the walk's seconds)."""
    mode = FakeTensorMode()
    specs = input_specs(cfg, model, shape, mode)
    params = specs["params"]
    b, t = shape.global_batch, shape.seq_len
    t0 = time.time()
    with activation_mesh(mesh):
        p_sh = param_shardings(params, mesh)
        if shape.kind == "train":
            step = make_train_step(model)
            opt_sh = AdamWState(step=replicated(mesh), mu=p_sh, nu=p_sh)
            in_sh = (p_sh, opt_sh, batch_shardings(specs["batch"], mesh))
            args = (params, specs["opt_state"], specs["batch"])
            call = args
        elif shape.kind == "prefill":
            step = make_prefill_step(model, cfg)
            c_sh = cache_shardings(specs["cache"], mesh, batch=b)
            in_sh = (p_sh, batch_shardings(specs["tokens"], mesh), c_sh)
            args = (params, specs["tokens"], specs["cache"])
            if cfg.is_encoder_decoder:
                in_sh += (batch_shardings(specs["frames"], mesh),)
                args += (specs["frames"],)
            call = args
        else:  # decode
            step = make_decode_step(model)
            c_sh = cache_shardings(specs["cache"], mesh, batch=b,
                                   seq_shard=b < mesh.shape["data"])
            in_sh = (p_sh, batch_shardings(specs["tokens"], mesh), c_sh,
                     replicated(mesh))
            args = (params, specs["tokens"], specs["cache"], specs["pos"])
            call = args[:3] + (t - 1,)
        out = []
        with mode:
            cost = analyze(lambda: out.append(step(*call)))
        walk_s = time.time() - t0
        # the outputs: the params, moments and caches in their inputs'
        # shardings; logits split over the batch; a loss replicated
        if shape.kind == "train":
            out_sh = in_sh[:2] + (replicated(mesh),)
        else:
            out_sh = (batch_shardings(out[0][0], mesh), in_sh[2])
        return cost, _bytes(args, in_sh), _bytes(out[0], out_sh), walk_s


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              verbose: bool = True, extra_tag: str = "",
              test_mesh: bool = False, report_dir: Path = REPORT_DIR):
    """Walk one (arch, shape, mesh); returns the roofline record."""
    cfg, model = build(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_test_mesh(multi_pod=multi_pod) if test_mesh \
        else make_production_mesh(multi_pod=multi_pod)
    skip = shape_applicable(cfg, shape)
    if skip is not None:
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {skip}")
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
               "status": "skipped", "reason": skip}
        _write(rec, Path(report_dir))
        return rec

    cost, arg_bytes, out_bytes, walk_s = walk_step(cfg, model, shape, mesh)
    entry = batch_spec(shape.global_batch, mesh)[0]
    shards = math.prod(mesh.shape[a] for a in (
        () if entry is None else (entry,) if isinstance(entry, str)
        else entry))
    report = build_report(arch, shape, mesh.name, mesh.size, cost,
                          arg_bytes + out_bytes
                          + cost.peak_live_bytes / shards, cfg)
    rec = report.to_dict()
    rec.update(status="ok", walk_s=round(walk_s, 1))
    if counted_as_plain(cfg):
        rec["counted_as_plain"] = counted_as_plain(cfg)

    if verbose:
        coll = ("not counted" if report.t_collective is None
                else f"{report.t_collective * 1e3:.2f}ms")
        print(f"[dryrun] {arch} x {shape_name} @ {mesh.name}: OK "
              f"(walk {walk_s:.1f}s)")
        print(f"  flops={report.hlo_flops:.3e} bytes={report.hlo_bytes:.3e}"
              f" peak/dev={report.peak_memory_bytes:.3e}")
        print(f"  roofline: compute={report.t_compute * 1e3:.2f}ms "
              f"memory={report.t_memory * 1e3:.2f}ms collective={coll} "
              f"-> {report.bottleneck}-bound "
              f"(useful {report.useful_flops_ratio:.2f})")
    _write(rec, Path(report_dir), f"_{extra_tag}" if extra_tag else "")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures: List[tuple] = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    lower_one(arch, shape, multi_pod=mp,
                              extra_tag=args.tag)
                except Exception as e:            # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[dryrun] FAIL {arch} x {shape} "
                          f"multi_pod={mp}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES")
        return 1
    print("\n[dryrun] all combinations walked")
    return 0


if __name__ == "__main__":
    sys.exit(main())
