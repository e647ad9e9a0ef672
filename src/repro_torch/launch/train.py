"""Training launcher: `python -m repro_torch.launch.train` (or `python -m
repro_torch train`).

    python -m repro_torch.launch.train --arch rwkv6_1b6 --reduced \
        --steps 50 --batch 8 --seq 128 [--torch-device cpu]

The port's counterpart of `repro.launch.train`: seeded weights (a torch
generator seeded 0, on the training device), the synthetic token stream
(seed 0; an encoder-decoder's frames from `make_batch(cfg, batch, seq,
seed=step)`), AdamW with a cosine schedule whose warmup is a tenth of
the steps, one line per `--log-every` steps, an optional checkpoint of
the params in the reference's layout after the last step, and the final
against the initial loss (the mean of the last five against the first
five), which must have fallen.  It runs on CUDA unless `--torch-device
cpu`; without CUDA and without that flag it exits 2.

As the reference's, it trains on a device mesh (`launch/mesh.py`): the
host mesh, (1, 1) over the training device, or with `--production-mesh`
the (16, 16) production mesh.  Under `activation_mesh(mesh)` the
params are placed by `param_shardings` (`sharding.shard_params`), then
trained.  The port runs one process on one device, so the production
mesh exits 2, naming the devices it needs and the one this process has
(the reference's `jax.make_mesh` raises there too without 256 devices).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import DataConfig, SyntheticTokenStream, make_batch
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import (ARCH_IDS, build_model, get_config,
                                params_to_reference)
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.sharding.ctx import activation_mesh
from repro_torch.sharding.rules import (param_shardings, require_devices,
                                        shard_params)


def train(cfg, model, params, *, steps: int, batch: int, seq: int,
          lr: float, device, log_every: int = 10):
    """`steps` AdamW steps of `params` (updated in place) on the synthetic
    stream.  Returns (params, optimizer state, losses, seconds per step:
    host wall of each step, its loss read back)."""
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(1, steps // 10))
    step_fn = make_train_step(model, opt_cfg)
    opt_state = init_adamw(params)
    stream = iter(SyntheticTokenStream(cfg.vocab_size,
                                       DataConfig(batch, seq, seed=0)))
    losses: List[float] = []
    seconds: List[float] = []
    t0 = time.time()
    for step in range(steps):
        raw = next(stream)
        if cfg.is_encoder_decoder:
            raw["frames"] = make_batch(cfg, batch, seq, seed=step)["frames"]
        t = time.perf_counter()
        data = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        params, opt_state, loss = step_fn(params, opt_state, data)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t)
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt / (step + 1):.2f}s/step)", flush=True)
    return params, opt_state, losses, seconds


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the 16 x 16 production mesh (this "
                         "process runs on one device: exits 2)")
    ap.add_argument("--torch-device", default=None,
                    help="torch device to train on (default: cuda)")
    return ap


def train_main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.core.coexec import resolve_device

    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.torch_device)
        mesh = make_production_mesh() if args.production_mesh \
            else make_host_mesh(device)
        require_devices(mesh)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    with activation_mesh(mesh):
        params = model.init(torch.Generator(device=device).manual_seed(0))
        params = shard_params(params, param_shardings(params, mesh))
        params, _, losses, _ = train(cfg, model, params, steps=args.steps,
                                     batch=args.batch, seq=args.seq,
                                     lr=args.lr, device=device,
                                     log_every=args.log_every)
    if args.checkpoint_dir:
        out = save_checkpoint(args.checkpoint_dir, args.steps,
                              {"params": params_to_reference(params)})
        print(f"checkpoint -> {out}")
    final, initial = np.mean(losses[-5:]), np.mean(losses[:5])
    print(f"final loss {final:.4f} (initial {initial:.4f})")
    if not final < initial:
        raise AssertionError("loss did not decrease")
    return 0


if __name__ == "__main__":
    sys.exit(train_main())
