"""Shared inputs of the port's parity tests (no tests of its own).

`small_units()` is a network small enough to run in both packages on the
CPU that still reaches every path of the port's executor: a Winograd-
eligible conv (n1), 3x3 convs, max and global pooling, a stride-2 conv
followed by a 1x1 projection shortcut whose declared 16x16 input must be
re-materialized from the 8x8 activation (`_adapt`), and two linears.
"""
from __future__ import annotations

import json
from pathlib import Path

import repro
from repro.core.types import ConvOp, LinearOp

ROOT = Path(__file__).resolve().parents[1]
VGG16_ARTIFACT = ROOT / "src/repro_torch/artifacts/vgg16_moto2022.coexec.json"
ZAMBA_ARTIFACT = (ROOT / "src/repro_torch/artifacts/"
                  "zamba2-7b_b9_s4096_moto2022_t1.coexec.json")


def small_units():
    return [("conv", ConvOp(32, 32, 3, 32, 3, 1)),
            ("conv", ConvOp(32, 32, 32, 128, 3, 1)),
            ("conv", ConvOp(32, 32, 128, 128, 3, 1)),
            ("pool", 4 * 16 * 16 * 128),
            ("conv", ConvOp(16, 16, 128, 128, 3, 1)),
            ("conv", ConvOp(16, 16, 128, 128, 3, 2)),
            ("conv", ConvOp(16, 16, 128, 128, 1, 2)),
            ("pool", 4 * 128),
            ("linear", LinearOp(1, 128, 64)),
            ("linear", LinearOp(1, 64, 10))]


def compile_small(mode: str, cache_dir: Path):
    """The small network compiled by the JAX package in `mode` ("grid" or
    "predicted", with small predictors), cached under `cache_dir`."""
    kw = {} if mode == "grid" else {"samples": 120, "estimators": 25}
    return repro.compile(small_units(),
                         repro.Target(device="moto2022", threads=3),
                         mode=mode, cache=cache_dir, **kw)


#: units along each typed partition axis of a decision's op JSON
_AXIS_SIZE = {"head": "H", "ssm-state": "H", "kv-block": "S"}


def forced_split_doc(compiled, splits):
    """The compiled artifact's JSON with `splits` forced onto its schedule,
    re-checksummed as the JAX package would.  `splits` maps a schedule
    position (or a node id) to the fast side's share: `c_gpu` output
    channels for a channel split, or `(axis, n_fast)` for a typed axis
    (head, kv-block, ssm-state), `n_fast` counted in that axis' units."""
    from repro.api import _artifact_checksum
    doc = json.loads(json.dumps(compiled.to_json()))
    schedule = doc["plan"]["schedule"]
    for key, share in splits.items():
        entry = (schedule[key] if isinstance(key, int) else
                 next(e for e in schedule if e.get("id") == key))
        dec = entry["decision"]
        if isinstance(share, tuple):
            axis, n_fast = share
            dec["axis"] = axis
            dec["c_gpu"] = n_fast
            dec["c_cpu"] = dec["op"][_AXIS_SIZE[axis]] - n_fast
        else:
            dec["c_gpu"] = share
            dec["c_cpu"] = dec["op"]["C_out"] - share
    doc.pop("checksum")
    doc["checksum"] = _artifact_checksum(doc)
    return doc
