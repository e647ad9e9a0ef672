"""`split_matmul`'s tiled product (M > 8) against the JAX package's kernel,
and its launch planner, on the CPU.

For M > 8 `split_matmul` launches `tc_gemm` (`csrc/split_matmul.cu`): a
block of 8 warps owns a bm x bn tile of Y and walks its K chunk in
`GEMM_BK`-row stages, every product on the tensor cores.  In fp32 each
operand is split into its TF32 parts, big = tf32(v) by truncation and
small = tf32(v - big), and a k-step of 8 adds small big, big small and big
big to the fp32 accumulators; a split grid's fp32 partials are summed by
`splitk_reduce` in a fixed order.  `_tiled_mirror` is that arithmetic in
plain PyTorch, k-step by k-step.  It is held against the reference's
Pallas kernel (`interpret=True`) at rwkv6-1.6b's 280-wide K = 4096 panel,
scaled down in M only, within the fp32 tolerance the card holds the
kernel to (`chip_smoke.KERNEL_RTOL`); one TF32 product alone is shown to
miss it.

The planner (`plan_launch`, `plan_tiled`) is checked at every M = 512
panel and whole weight of rwkv6-1.6b's 512-token plan and at short M:
K chunks cover K in whole steps, none empty; a split grid is at most one
wave of the blocks an SM holds; no split where the tiles alone fill a
wave; explicit launches are held to the table's rules.
"""
import importlib
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.split_matmul.split_matmul import (
    split_matmul as jax_split_matmul)

from repro_torch.kernels import build, tiles
from repro_torch.kernels.split_matmul import split_matmul, split_matmul_plain

from test_torch_ssd_chunk import _tf32

sm = importlib.import_module("repro_torch.kernels.split_matmul.split_matmul")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: kernel vs reference, relative to the largest |reference| value
RTOL = chip_smoke.KERNEL_RTOL[torch.float32]

SMS = 132                        # an H100 SXM
ALIGNED = 0x7f0000000000         # a 16-byte-aligned device address
#: tiled blocks an SM holds, as a card might give them (fp32 128 x 128
#: blocks hold one SM each), and one count for every block
RESIDENCIES = {"by block": {(64, 64): 3, (128, 64): 2, (64, 128): 2,
                            (128, 128): 1},
               "two each": 2}

#: the kernel's warps in `splitk_reduce`, which sum the splits strided
REDUCE_WARPS = 8


def _tiled_mirror(x, w, plan, products: int = 3) -> torch.Tensor:
    """Y = X @ W as `tc_gemm` and `splitk_reduce` compute it, in plain
    PyTorch (fp32): each split's chunk of K in k-steps of 8 in order, each
    step's product as the kernel's three TF32 products (small big, big
    small, big big) or, with `products=1`, one (big big); then the
    partials summed as `splitk_reduce` sums them: warp v adds splits v,
    v + 8, ... in order, and the warps' sums are added in warp order."""
    xf, wf = torch.as_tensor(x).float(), torch.as_tensor(w).float()
    k = xf.shape[1]
    parts = []
    for kb, ke in plan.k_ranges(k):
        acc = torch.zeros(xf.shape[0], wf.shape[1])
        for k0 in range(kb, ke, 8):
            a, b = xf[:, k0:min(ke, k0 + 8)], wf[k0:min(ke, k0 + 8)]
            ab, bb = _tf32(a), _tf32(b)
            if products == 3:
                acc = acc + _tf32(a - ab) @ bb
                acc = acc + ab @ _tf32(b - bb)
            acc = acc + ab @ bb
        parts.append(acc)
    if len(parts) == 1:
        return parts[0]
    sums = []
    for v in range(REDUCE_WARPS):
        s = torch.zeros_like(parts[0])
        for p in parts[v::REDUCE_WARPS]:
            s = s + p
        sums.append(s)
    y = torch.zeros_like(parts[0])
    for s in sums:
        y = y + s
    return y


def _rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plan_panels():
    """(K, N, width) of every tiled call of one request of rwkv6-1.6b's
    512-token plan: both sides of each channel split, on their (K, c_pad)
    panels of the packed weights."""
    import repro_torch
    from repro_torch.core.coexec import SplitPlan
    compiled = repro_torch.CompiledNetwork.load(
        chip_smoke.ARTIFACTS / "rwkv6-1.6b_b24_tok512_moto2022_t1.coexec.json")
    out = set()
    for d in compiled.decisions:
        if type(d.op).__name__ != "LinearOp":
            continue
        assert d.op.L == 512 and d.axis == "channel" and d.c_cpu and d.c_gpu
        split = SplitPlan(c_out=d.op.C_out, c_fast=d.c_gpu)
        out |= {(d.op.C_in, split.c_pad, split.width(side))
                for side in range(2)}
    return sorted(out)


PANELS = _plan_panels()
#: rwkv6-1.6b's whole weights at M = 512, and short-M calls
WHOLE = [(2048, 2048, 2048), (2048, 4096, 4096), (4096, 2048, 2048)]
SHAPES = ([(512, *p) for p in PANELS] + [(512, *w) for w in WHOLE]
          + [(9, 768, 3072, 592), (17, 100, 301, 128), (50, 768, 3072, 592),
             (64, 3584, 3584, 3584), (64, 256, 200, 200)])


def test_the_plan_has_the_panels_the_records_name():
    assert PANELS == [(2048, 1648, 400), (2048, 1648, 1648),
                      (2048, 3816, 280), (2048, 3816, 3816),
                      (4096, 1768, 280), (4096, 1768, 1768)]


# ------------------------------------------------------- the arithmetic
@pytest.mark.parametrize("m", [16, 40])
def test_3xtf32_mirror_matches_the_jax_kernel_on_the_k4096_panel(m):
    """The 280-wide K = 4096 panel (its split at M = 512, 11 chunks of 384
    rows), scaled down in M only: the kernel's arithmetic within RTOL of
    the reference's Pallas kernel, and of the plain version; one TF32
    product alone outside it."""
    k, width = 4096, 280
    plan = sm.plan_launch(512, k, width, 0, width, 4, ALIGNED, SMS,
                          RESIDENCIES["by block"])
    assert (plan.mt, plan.tile, plan.splits, plan.k_chunk) == \
        (128, 128, 11, 384)
    rng = np.random.default_rng(m * 4099)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, width)) / np.sqrt(k)).astype(np.float32)
    want = np.asarray(jax_split_matmul(jnp.asarray(x), jnp.asarray(w), 0,
                                       width, interpret=True))
    got = _tiled_mirror(x, w, plan)
    assert _rel_err(got, want) <= RTOL
    plain = split_matmul_plain(torch.from_numpy(x), torch.from_numpy(w), 0,
                               width)
    assert _rel_err(got, plain) <= RTOL
    assert _rel_err(_tiled_mirror(x, w, plan, products=1), want) > RTOL


@pytest.mark.parametrize("splits", [1, 3, 11, 16])
def test_the_split_sums_regroup_within_the_tolerance(splits):
    """Any legal split of the same K gives the same Y within RTOL: the
    splits regroup the fp32 sum, which `splits` marks a reduction-axis
    launch parameter for."""
    m, k, width = 24, 2048, 136
    rng = np.random.default_rng(splits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, width)) / np.sqrt(k)).astype(np.float32)
    launch = tiles.launch_spec("linear").config(splits=splits)
    tiles.check_launch("linear", launch, {"m": m, "k": k, "n": width})
    plan = sm.plan_launch(m, k, width, 0, width, 4, ALIGNED, SMS, 1, launch)
    assert plan.splits == splits
    want = x.astype(np.float64) @ w.astype(np.float64)
    assert _rel_err(_tiled_mirror(x, w, plan), want) <= RTOL


# ---------------------------------------------------------- the planner
@pytest.mark.parametrize("resident", sorted(RESIDENCIES))
@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_plans_cover_k_in_whole_steps_within_one_wave(shape, elt,
                                                            resident):
    m, k, n, width = shape
    res = RESIDENCIES[resident]
    plan = sm.plan_launch(m, k, n, 0, width, elt, ALIGNED, SMS, res)
    assert plan.variant == (sm.TILED if n * elt % 16 == 0 else
                            sm.TILED_NARROW)
    assert (plan.mt, plan.tile) in sm.GEMM_BLOCKS
    assert plan.row_tiles == -(-m // plan.mt)
    assert plan.col_tiles == -(-width // plan.tile)
    # K chunks: whole GEMM_BK steps, contiguous from 0 to K, none empty
    assert plan.k_chunk % sm.GEMM_BK == 0
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, end), (begin, _) in zip(ranges, ranges[1:]):
        assert begin == end
    assert all(0 < e - b <= plan.k_chunk for b, e in ranges)
    # what the C launcher checks before it launches
    assert plan.splits == max(1, -(-k // plan.k_chunk))
    slots = sm._blocks_of(res, plan.mt, plan.tile) * SMS
    tiles_ = plan.row_tiles * plan.col_tiles
    if plan.splits > 1:
        assert plan.blocks <= slots
        assert plan.k_chunk >= sm.MIN_SPLIT_STEPS * sm.GEMM_BK
    if tiles_ >= slots:
        assert plan.splits == 1
    # a launch could name the block the planner picked
    tiles.check_launch("linear", tiles.launch_spec("linear").config(
        bm=plan.mt, bn=plan.tile), {"m": m, "k": k, "n": width})


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] == 512],
                         ids=lambda s: "x".join(map(str, s)))
def test_m512_grids_fill_the_card(shape):
    """At M = 512 every call of the plan takes 128 x 128 blocks (one an SM
    in fp32) and fills at least three quarters of one wave: the narrow
    sides by splitting K, the wide ones by their tiles."""
    m, k, n, width = shape
    plan = sm.plan_launch(m, k, n, 0, width, 4, ALIGNED, SMS,
                          RESIDENCIES["by block"])
    assert (plan.mt, plan.tile) == (128, 128)
    assert 0.75 * SMS <= plan.blocks <= SMS


@pytest.mark.parametrize("resident", sorted(RESIDENCIES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_a_named_block_keeps_the_planners_split(shape, resident):
    """Output-tiling launches: every legal block of the table, named
    without `splits`, keeps the default plan's split and so its K chunks;
    only the block changes."""
    m, k, n, width = shape
    res = RESIDENCIES[resident]
    spec = tiles.launch_spec("linear")
    extents = {"m": m, "k": k, "n": width}
    default = sm.plan_launch(m, k, n, 0, width, 4, ALIGNED, SMS, res)
    for launch in spec.configs(extents):
        got = sm.plan_launch(m, k, n, 0, width, 4, ALIGNED, SMS, res,
                             launch)
        assert (got.splits, got.k_chunk) == (default.splits,
                                             default.k_chunk), launch
        assert (got.mt, got.tile) == ((launch.get("bm"), launch.get("bn"))
                                      if launch.values else
                                      (default.mt, default.tile))


@pytest.mark.parametrize("ptr,c0,n,k,elt,variant", [
    (0, 0, 4096, 2048, 4, "TILED"),
    (0, 3, 4096, 2048, 4, "TILED_NARROW"),     # W[0, c0] 12 bytes in
    (0, 4, 4096, 2048, 2, "TILED_NARROW"),     # bf16: 8 bytes in
    (0, 8, 4096, 2048, 2, "TILED"),
    (0, 0, 301, 2048, 4, "TILED_NARROW"),      # W's pitch 1204 B
    (0, 0, 4096, 515, 4, "TILED_NARROW"),      # X's pitch 2060 B
    (4, 0, 4096, 2048, 4, "TILED_NARROW")])    # X four bytes in
def test_16_byte_copies_only_where_x_and_w_are_aligned(ptr, c0, n, k, elt,
                                                       variant):
    plan = sm.plan_launch(64, k, n, c0, 256, elt, ALIGNED, SMS, 2,
                          x_ptr=ALIGNED + ptr)
    assert plan.variant == getattr(sm, variant)


@pytest.mark.parametrize("label,launch,m,k,n", [
    ("splits not whole steps", {"splits": 3}, 16, 100, 40),
    ("splits over the steps", {"splits": 8}, 16, 100, 40),
    ("bm 96", {"bm": 96, "bn": 64}, 100, 64, 40),
    ("bm over M", {"bm": 128, "bn": 64}, 64, 64, 40),
    ("bn alone", {"bn": 128}, 64, 64, 200)])
def test_illegal_tiled_launches_raise(label, launch, m, k, n):
    """Validated, never clamped: on CPU tensors too, before the plain
    version runs.  K = 100 is two 64-row steps: three splits would take
    chunks of one step, which make two."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((k, n), generator=g)
    with pytest.raises(ValueError):
        split_matmul(x, w, 0, n, launch=launch)


def test_the_planner_and_the_kernel_share_their_facts():
    """The K step and the instantiated blocks the planner assumes are the
    CUDA source's."""
    src = (build.CSRC / "split_matmul.cu").read_text()
    assert int(re.search(r"constexpr int kBK = (\d+);", src).group(1)) == \
        sm.GEMM_BK == tiles.GEMM_BK
    blocks = {(int(a), int(b)) for a, b in re.findall(
        r"if \(bm == (\d+) && bn == (\d+)\) return f\(Tiled", src)}
    assert blocks == set(sm.GEMM_BLOCKS)
    assert set(sm.TILED_BLOCK_PACE) == set(sm.GEMM_BLOCKS)
    # the SIMT product it replaced is gone; its header keeps the
    # conversions the other kernels include it for
    assert "tiled_gemm<" not in src
    assert "__global__" not in (build.CSRC / "tiled_gemm.cuh").read_text()
