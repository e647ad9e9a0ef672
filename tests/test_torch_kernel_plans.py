"""The launch planners of the port's two GEMM kernels, on the CPU.

`plan_launch` (split_matmul's split-K GEMV) and `plan_hadamard`
(hadamard_matmul's register-blocked GEMM) are the host halves of the CUDA
kernels: the variant, the tile, the number of K splits and the K chunk
that the C launchers take as arguments.  The shapes are the ones
`chip_smoke.py` runs on the card (`SPLIT_CASES`, `HADAMARD_CASES`), read
from the script so the two stay one list.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.coexec import SplitPlan, pack_weights
from repro_torch.kernels.split_matmul import split_matmul
from repro_torch.kernels.split_matmul.split_matmul import (
    MIN_BLOCK_BYTES, SCALAR, TILED, VECTOR, X_STAGE_BYTES, plan_launch)
from repro_torch.kernels.winograd_conv.winograd_conv import (TILES,
                                                             plan_hadamard)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = 132                        # an H100 SXM
RESIDENT = 4                     # GEMV blocks an SM holds at M = 1
ALIGNED = 0x7f0000000000         # a 16-byte-aligned device address
SPLIT_CASES = [c[:6] for c in chip_smoke.SPLIT_CASES]
MAIN_SPLIT = [c[:6] for c in chip_smoke.SPLIT_CASES if c[6]]
ELTS = {"float32": 4, "bfloat16": 2}


# ------------------------------------------------------------ split_matmul
@pytest.mark.parametrize("dtype", list(ELTS))
@pytest.mark.parametrize("case", SPLIT_CASES + [
    ("K=1", 1, 1, 64, 0, 64), ("K prime", 3, 7919, 512, 0, 500),
    ("K < a block's floor", 8, 40, 4096, 0, 4096),
    ("K = 0", 1, 0, 128, 0, 128)], ids=lambda c: c[0])
def test_k_splits_cover_k_exactly(case, dtype):
    _, m, k, n, c0, width = case
    plan = plan_launch(m, k, n, c0, width, ELTS[dtype], ALIGNED, SMS,
                       RESIDENT)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits >= 1
    # contiguous, in order, from 0 to K: no gap and no overlap
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, end), (begin, _) in zip(ranges, ranges[1:]):
        assert begin == end
    assert all(0 < e - b <= plan.k_chunk for b, e in ranges) or k == 0
    # what the C launcher checks before it launches
    assert plan.splits == max(1, -(-k // plan.k_chunk))


@pytest.mark.parametrize("case", MAIN_SPLIT, ids=lambda c: c[0])
def test_main_path_shapes_fill_the_card(case):
    _, m, k, n, c0, width = case
    plan = plan_launch(m, k, n, c0, width, 4, ALIGNED, SMS, RESIDENT)
    assert plan.variant == VECTOR and plan.mt == 1
    assert plan.col_tiles * plan.tile >= width > (plan.col_tiles - 1) * \
        plan.tile
    # one full wave of the blocks the card holds at once (the whole card,
    # not one stream's share): no second, mostly empty wave
    slots = RESIDENT * SMS
    assert slots - plan.col_tiles < plan.blocks <= slots


@pytest.mark.parametrize("dtype", list(ELTS))
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c[0])
def test_no_block_streams_less_than_the_floor(case, dtype):
    _, m, k, n, c0, width = case
    elt = ELTS[dtype]
    plan = plan_launch(m, k, n, c0, width, elt, ALIGNED, SMS, RESIDENT)
    if plan.variant == TILED:
        return
    assert plan.splits == 1 or \
        plan.k_chunk * plan.tile * elt >= MIN_BLOCK_BYTES
    # and a block's rows of X fit its shared-memory stage
    assert plan.mt * plan.k_chunk * 4 <= X_STAGE_BYTES


@pytest.mark.parametrize("resident", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("k,width", [(25088, 3368), (4096, 4096),
                                     (3584, 1472), (14336, 2296)])
def test_the_grid_is_one_wave_of_resident_blocks(k, width, resident):
    plan = plan_launch(1, k, width, 0, width, 4, ALIGNED, SMS, resident)
    slots = resident * SMS
    assert plan.blocks <= slots
    # ... and within a column tile of it, unless a block would stream
    # less than the floor
    assert plan.blocks > slots - plan.col_tiles or \
        -(-k // (plan.splits + 1)) * plan.tile * 4 < MIN_BLOCK_BYTES


@pytest.mark.parametrize("m,mt", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                  (8, 8)])
def test_rows_of_x_round_up_to_a_power_of_two(m, mt):
    plan = plan_launch(m, 25088, 4096, 0, 4096, 4, ALIGNED, SMS, RESIDENT)
    assert plan.mt == mt
    assert plan.mt * plan.k_chunk * 4 <= X_STAGE_BYTES


def test_more_than_eight_rows_take_the_tiled_product():
    plan = plan_launch(9, 768, 3072, 2480, 592, 4, ALIGNED, SMS, RESIDENT)
    assert (plan.variant, plan.splits) == (TILED, 1)


@pytest.mark.parametrize("ptr_offset,c0,n,elt,variant", [
    (0, 0, 3368, 4, VECTOR),          # a packed panel
    (0, 728, 4096, 4, VECTOR),        # n18's slow side on the full W
    (0, 96, 301, 4, SCALAR),          # ragged N: the row pitch is 1204 B
    (0, 2480, 3072, 4, VECTOR),       # c0 * 4 and N * 4 are 16-aligned
    (0, 2480, 3072, 2, VECTOR),
    (0, 13, 77, 4, SCALAR),
    (0, 3, 1000, 4, SCALAR),          # odd c0
    (0, 4, 1000, 2, SCALAR),          # bf16: 8 bytes into the row
    (0, 8, 1000, 2, VECTOR),
    (0, 0, 1004, 2, SCALAR),          # bf16 pitch 2008 B
    (4, 0, 1000, 4, SCALAR),          # an odd pointer
    (12, 1, 1000, 4, VECTOR),         # ... that c0 brings back in line
])
def test_16_byte_loads_only_where_all_three_are_aligned(ptr_offset, c0, n,
                                                        elt, variant):
    plan = plan_launch(1, 4096, n, c0, min(64, n - c0), elt,
                       ALIGNED + ptr_offset, SMS, RESIDENT)
    assert plan.variant == variant


@pytest.mark.parametrize("c_out,c_fast,dtype", [
    (3368 + 728, 728, torch.float32),   # n18's panels
    (1000, 328, torch.float32),
    (1000, 328, torch.bfloat16),
    (301, 96, torch.float32)])          # ragged: c_pad 208
def test_packed_panels_are_planned_on_their_actual_pointers(c_out, c_fast,
                                                            dtype):
    k = 40
    w = torch.zeros((k, c_out), dtype=dtype)
    plan = SplitPlan(c_out=c_out, c_fast=c_fast)
    packed = pack_weights(w, plan)
    for g in range(2):
        panel = packed[g]
        elt = panel.element_size()
        assert panel.data_ptr() == \
            packed.data_ptr() + g * k * plan.c_pad * elt
        got = plan_launch(1, k, plan.c_pad, 0, plan.width(g), elt,
                          panel.data_ptr(), SMS, RESIDENT)
        aligned = panel.data_ptr() % 16 == 0 and (plan.c_pad * elt) % 16 == 0
        assert got.variant == (VECTOR if aligned else SCALAR)
    # c_pad is a multiple of 8 channels: both panels take 16-byte loads
    # wherever the packed tensor itself is 16-byte aligned
    if packed.data_ptr() % 16 == 0:
        assert all(plan_launch(1, k, plan.c_pad, 0, plan.width(g),
                               packed.element_size(), packed[g].data_ptr(),
                               SMS, RESIDENT).variant == VECTOR
                   for g in range(2))


@pytest.mark.parametrize("case", SPLIT_CASES[:4] + [
    ("ragged M=3", 3, 1000, 301, 96, 128)], ids=lambda c: c[0])
def test_split_k_partials_sum_to_the_product(case):
    """The kernel's arithmetic under the plan, in numpy: each split's fp32
    partial over its rows of K, summed in split order."""
    _, m, k, n, c0, width = case
    rng = np.random.default_rng(k + width)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, width)).astype(np.float32) / np.sqrt(k)
    plan = plan_launch(m, k, n, c0, width, 4, ALIGNED, SMS, RESIDENT)
    y = np.zeros((m, width), np.float32)
    for b, e in plan.k_ranges(k):
        y += x[:, b:e] @ w[b:e]
    np.testing.assert_allclose(y, x.astype(np.float64) @ w, rtol=1e-4,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_planning():
    x, w = torch.ones(1, 64), torch.ones(64, 300)
    before = split_matmul.launches
    assert torch.equal(split_matmul(x, w, 3, 297), torch.full((1, 297), 64.))
    assert split_matmul.launches == before


# --------------------------------------------------------- hadamard_matmul
@pytest.mark.parametrize("dtype", list(ELTS))
@pytest.mark.parametrize("case", chip_smoke.HADAMARD_CASES,
                         ids=lambda c: c[0])
def test_hadamard_tile_covers_p_and_n(case, dtype):
    _, p, k, n, _ = case
    plan = plan_hadamard(16, p, k, n, ELTS[dtype], (ALIGNED,) * 3, SMS)
    gx, gy, gz = plan.grid
    assert (plan.bm, plan.bn) in TILES and gz == 16
    assert gx * plan.bn >= n > (gx - 1) * plan.bn
    assert gy * plan.bm >= p > (gy - 1) * plan.bm
    assert plan.vec


def _rounds_cost(p, n, tile):
    (bm, bn), resident = tile, TILES[tile]
    busiest = -(-16 * -(-p // bm) * -(-n // bn) // SMS)
    return -(-busiest // resident) * resident * bm * bn


@pytest.mark.parametrize("p,n,tile", [
    (3136, 128, (64, 128)),    # n3, n4: 784 blocks, 6 on the busiest SM
    (784, 256, (128, 128)),    # n7/n8: 224 blocks, one round everywhere
    (784, 192, (128, 64)),     # n6 fast
    (784, 64, (128, 64)),      # n6 slow: a tie with 64 x 128, the wider
    (50000, 512, (128, 128))])
def test_hadamard_tile_gives_the_busiest_sm_the_fewest_rounds(p, n, tile):
    plan = plan_hadamard(16, p, 128, n, 4, (ALIGNED,) * 3, SMS)
    assert (plan.bm, plan.bn) == tile
    assert _rounds_cost(p, n, tile) == min(_rounds_cost(p, n, t)
                                           for t in TILES)


@pytest.mark.parametrize("k,n,elt,offsets,vec", [
    (64, 128, 4, (0, 0, 0), True),
    (40, 136, 4, (0, 0, 0), True),
    (33, 128, 4, (0, 0, 0), False),     # K * 4 not a multiple of 16
    (64, 70, 4, (0, 0, 0), False),      # N * 4 not a multiple of 16
    (36, 128, 2, (0, 0, 0), False),     # bf16: K must be a multiple of 8
    (64, 128, 2, (0, 0, 0), True),
    (64, 128, 4, (0, 4, 0), False),     # an odd operand pointer
    (64, 128, 4, (0, 0, 8), False)])    # an odd output pointer
def test_hadamard_copies_16_bytes_only_where_aligned(k, n, elt, offsets,
                                                    vec):
    ptrs = tuple(ALIGNED + o for o in offsets)
    assert plan_hadamard(16, 100, k, n, elt, ptrs, SMS).vec == vec
