"""The launch planners of the port's kernels, on the CPU.

`plan_launch` (split_matmul's split-K GEMV), `plan_hadamard`
(hadamard_matmul's register-blocked GEMM), `plan_attention`
(decode_attention's runs over the attended range) and `plan_ssd`
(ssd_chunk_scan's decode or chunk kernel) are the host halves of the CUDA
kernels: the variant, the tiles, the splits or runs and the block shape
that the C launchers take as arguments.  The shapes are the ones
`chip_smoke.py` runs on the card (`SPLIT_CASES`, `HADAMARD_CASES`,
`ATTN_CASES`, `SSD_CASES`), read from the script so the two stay one list.
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.coexec import SplitPlan, pack_weights
from repro_torch.kernels import build
from repro_torch.kernels.split_matmul import split_matmul
from repro_torch.kernels.split_matmul.split_matmul import (
    MIN_BLOCK_BYTES, SCALAR, TILED, VECTOR, X_STAGE_BYTES, plan_launch)
from repro_torch.kernels.winograd_conv.winograd_conv import (TILES,
                                                             plan_hadamard)

# the kernel modules (their packages export the wrappers by the same names)
da = importlib.import_module(
    "repro_torch.kernels.decode_attention.decode_attention")
sc = importlib.import_module("repro_torch.kernels.ssd_chunk.ssd_chunk")

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
    # not one stream's share): no second, mostly empty wave; a short K
    # (the resnets' and inception_v3's 512- and 2048-row classifiers)
    # fills less of it only where K is split as often as the floor allows
    # (every block streams at least MIN_BLOCK_BYTES of W)
    slots = RESIDENT * SMS
    assert plan.blocks <= slots
    assert plan.blocks > slots - plan.col_tiles or \
        plan.splits == k * plan.tile * 4 // MIN_BLOCK_BYTES


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


def _batch4_panels():
    """(K, C_out, c_fast) of every channel split in the batch-4 entries of
    the committed zamba2-7b portfolio, whose GEMVs run at M = 4."""
    import repro_torch
    pf = repro_torch.PlanPortfolio.load(
        Path(__file__).resolve().parents[1] / "src/repro_torch/artifacts"
        / "zamba2-7b_b9_moto2022_t1.portfolio.json")
    return sorted({(d.op.C_in, d.op.C_out, d.c_gpu)
                   for b, c in pf.entries.items() if b.batch == 4
                   for d in c.decisions
                   if d.axis == "channel" and d.c_cpu and d.c_gpu})


@pytest.mark.parametrize("dtype", list(ELTS))
@pytest.mark.parametrize("panel", _batch4_panels(), ids=str)
def test_batch4_panels_take_the_gemv(panel, dtype):
    """Both sides of every batch-4 channel split of the committed
    portfolio run the vector GEMV with four rows of X per block."""
    k, c_out, c_fast = panel
    split = SplitPlan(c_out=c_out, c_fast=c_fast)
    for side in range(2):
        width = split.width(side)
        plan = plan_launch(4, k, split.c_pad, 0, width, ELTS[dtype],
                           ALIGNED, SMS, RESIDENT)
        assert (plan.variant, plan.mt) == (VECTOR, 4)
        ranges = plan.k_ranges(k)
        assert ranges[0][0] == 0 and ranges[-1][1] == k
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


# -------------------------------------------------------- decode_attention
ATTN_RESIDENT = 2 * SMS          # fp32 pass-1 blocks of ~86 KB: 2 per SM
ATTN_CASES = [(c[0], c[1] // c[2], *c[2:7]) for c in chip_smoke.ATTN_CASES]
ATTN_EDGES = [("one position", 4, 2, 16, 1, 0, 0),
              ("one tile and one", 4, 2, 16, 33, 32, 0),
              ("more KV heads than slots", 1, 600, 16, 64, 63, 0),
              ("window inside", 2, 4, 64, 5000, 4000, 100)]


def _attn_plan(case, elt, resident=ATTN_RESIDENT, ptr=ALIGNED):
    _, g, kv, hd, s, pos, window = case
    lo, hi = da.valid_range(s, pos, window)
    return lo, hi, da.plan_attention(lo, hi, kv, g, hd, elt, ptr, ptr,
                                     resident)


@pytest.mark.parametrize("resident", [1, 33, ATTN_RESIDENT, 4 * SMS])
@pytest.mark.parametrize("dtype", list(ELTS))
@pytest.mark.parametrize("case", ATTN_CASES + ATTN_EDGES, ids=lambda c: c[0])
def test_attention_runs_cover_the_valid_range_exactly(case, dtype,
                                                      resident):
    lo, hi, plan = _attn_plan(case, ELTS[dtype], resident)
    runs = plan.runs()
    assert len(runs) == plan.nsplit >= 1
    # contiguous, in order, from lo to hi: nothing masked is read
    assert runs[0][0] == lo and runs[-1][1] == hi + 1
    for (_, end), (first, _) in zip(runs, runs[1:]):
        assert first == end
    # no empty run; whole tiles except the last run's end
    assert all(0 < e - b for b, e in runs)
    assert all(e - b == plan.run_len for b, e in runs[:-1])
    assert plan.run_len % plan.tile == 0 and runs[-1][1] - runs[-1][0] <= \
        plan.run_len
    # what the C launcher checks before it launches
    assert plan.nsplit == -(-(hi - lo + 1) // plan.run_len)


@pytest.mark.parametrize("resident", [1, 33, 64, ATTN_RESIDENT, 4 * SMS])
@pytest.mark.parametrize("case", ATTN_CASES + ATTN_EDGES, ids=lambda c: c[0])
def test_attention_grid_is_one_wave_of_resident_blocks(case, resident):
    lo, hi, plan = _attn_plan(case, 4, resident)
    kv = case[2]
    tiles = -(-(hi - lo + 1) // plan.tile)
    assert plan.blocks == kv * plan.nsplit
    # at most one wave, unless the KV heads alone are more than that
    assert plan.blocks <= resident or plan.nsplit == 1
    # ... and no more than a run's tiles short of it, unless every run is
    # a single tile already
    assert plan.nsplit >= min(tiles, resident // kv) // plan.run_tiles or \
        plan.run_tiles == 1
    assert plan.nsplit * plan.run_tiles >= min(tiles, max(1, resident // kv))


def test_attention_main_path_sides_take_eight_runs_per_kv_head():
    fast, slow = (c for c in ATTN_CASES if chip_smoke.ATTN_CASES[
        ATTN_CASES.index(c)][7])
    for case, run_len in ((fast, 384), (slow, 128)):
        _, _, plan = _attn_plan(case, 4)
        assert (plan.variant, plan.nsplit, plan.run_len, plan.blocks) == \
            (da.VECTOR, 8, run_len, 256)
        # 2 x 86 KB blocks fit an SM's 228 KB
        assert 2 * plan.smem <= 228 * 1024 < 3 * plan.smem


def test_attention_window_plans_no_block_over_masked_positions():
    case = next(c for c in ATTN_CASES if c[6])          # "window 1024"
    _, g, kv, hd, s, pos, window = case
    lo, hi, plan = _attn_plan(case, 4)
    assert (lo, hi) == (pos - window + 1, pos)
    attended = sum(e - b for b, e in plan.runs())
    # per KV head the runs span the window's 1024 positions, not the
    # cache's 8192
    assert attended == window == plan.nsplit * plan.run_len
    assert all(lo <= b < e <= hi + 1 for b, e in plan.runs())


@pytest.mark.parametrize("k_off,v_off,kv,hd,elt,variant", [
    (0, 0, 32, 112, 4, da.VECTOR),      # zamba2-7b: 28 float4s per row
    (0, 0, 32, 112, 2, da.VECTOR),      # bf16: 14 16-byte chunks
    (4, 0, 32, 112, 4, da.SCALAR),      # an odd K pointer
    (0, 8, 32, 112, 4, da.SCALAR),      # an odd V pointer
    (2, 2, 32, 112, 2, da.SCALAR),
    (16, 48, 8, 128, 4, da.VECTOR),     # offsets of whole 16-byte chunks
    (0, 0, 2, 36, 4, da.VECTOR),        # hd * 4 = 144: aligned
    (0, 0, 2, 36, 2, da.SCALAR),        # hd * 2 = 72: not
    (0, 0, 4, 6, 4, da.SCALAR),         # hd * 4 = 24, pitch 96
])
def test_attention_copies_16_bytes_only_where_all_are_aligned(
        k_off, v_off, kv, hd, elt, variant):
    plan = da.plan_attention(0, 999, kv, 1, hd, elt, ALIGNED + k_off,
                             ALIGNED + v_off, ATTN_RESIDENT)
    assert plan.variant == variant
    assert plan.chunks == -(-hd * elt // 16)


def test_attention_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="16-byte chunks"):
        da.plan_attention(0, 99, 1, 40, 128, 4, ALIGNED, ALIGNED, 264)
    # a wide head: three stages of 32 rows of 2 KB for K and for V
    with pytest.raises(ValueError, match="shared memory"):
        da.plan_attention(0, 99, 1, 1, 512, 4, ALIGNED, ALIGNED, 264)
    with pytest.raises(ValueError, match="nothing to attend"):
        da.plan_attention(5, 4, 1, 1, 16, 4, ALIGNED, ALIGNED, 264)


def test_attention_smem_holds_the_ring_and_the_partial_sums():
    # hd = 112 fp32: 3 stages x (K, V) x 32 rows x 448 B, then q, scores
    # and (max, sum, rescale) for one head
    assert da.attn_smem(1, 112, 4) == 3 * 2 * 32 * 448 + 4 * (112 + 32 + 3)
    # a narrow head: the threads' partial sums outgrow the ring
    assert da.attn_smem(1, 8, 2) == da.THREADS * 8 * 4 + 4 * (8 + 32 + 3)


# ----------------------------------------------------------- ssd_chunk_scan
@pytest.mark.parametrize("dtype", list(ELTS))
@pytest.mark.parametrize("case", chip_smoke.SSD_CASES, ids=lambda c: c[0])
def test_ssd_takes_the_decode_kernel_up_to_decode_t_max(case, dtype):
    _, b, t, h, hd, n, _ = case
    plan = sc.plan_ssd(b, t, h, hd, n, ELTS[dtype], (ALIGNED, ALIGNED))
    if t <= sc.DECODE_T_MAX:
        assert plan.variant == sc.DECODE_VECTOR
        assert plan.smem == 4 * t * (1 + 2 * n + plan.rows)
    else:
        assert plan.variant == sc.CHUNKED
        assert (plan.blocks, plan.chunk) == (b * h, min(sc.CHUNK, t))


@pytest.mark.parametrize("t,variant", [
    (1, sc.DECODE_VECTOR), (sc.DECODE_T_MAX, sc.DECODE_VECTOR),
    (sc.DECODE_T_MAX + 1, sc.CHUNKED)])
def test_ssd_decode_t_max_is_the_boundary(t, variant):
    assert sc.plan_ssd(1, t, 112, 64, 64, 4, (ALIGNED,) * 2).variant == \
        variant


@pytest.mark.parametrize("hd", [1, 7, 16, 64, 100, 130])
@pytest.mark.parametrize("n", [1, 4, 12, 16, 64, 128, 200, 256])
def test_ssd_decode_rows_per_block_cover_hd(n, hd):
    plan = sc.plan_ssd(3, 1, 5, hd, n, 4, (ALIGNED,) * 2)
    assert plan.variant in (sc.DECODE_VECTOR, sc.DECODE_SCALAR)
    lanes, rows = plan.lanes, plan.rows
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert lanes * rows == sc.DECODE_THREADS
    # the row's lanes hold all N values, and half as many would not
    assert lanes * sc.LANE_ELEMS >= n and (lanes == 1 or
                                          lanes // 2 * sc.LANE_ELEMS < n)
    per_head = plan.blocks // (3 * 5)
    assert plan.blocks == 3 * 5 * per_head
    assert per_head * rows >= hd > (per_head - 1) * rows


@pytest.mark.parametrize("offsets,n,elt,variant", [
    ((0, 0), 64, 4, sc.DECODE_VECTOR),
    ((0, 0), 64, 2, sc.DECODE_VECTOR),
    ((4, 0), 64, 4, sc.DECODE_SCALAR),    # an odd state0
    ((0, 2), 64, 2, sc.DECODE_SCALAR),    # an odd final state
    ((0, 0), 12, 4, sc.DECODE_VECTOR),    # 48-byte rows
    ((0, 0), 12, 2, sc.DECODE_SCALAR),    # 24-byte rows
    ((0, 0), 6, 4, sc.DECODE_SCALAR),     # N not a multiple of 4
])
def test_ssd_decode_loads_16_bytes_only_where_aligned(offsets, n, elt,
                                                      variant):
    ptrs = tuple(ALIGNED + o for o in offsets)
    assert sc.plan_ssd(1, 1, 4, 16, n, elt, ptrs).variant == variant


def test_ssd_wide_states_and_long_scans_take_the_chunk_kernel():
    # N = 300 is over 32 lanes' registers; at T = 1 the chunk kernel runs
    assert sc.plan_ssd(1, 1, 4, 16, 300, 4, (ALIGNED,) * 2).variant == \
        sc.CHUNKED
    assert sc.plan_ssd(1, 4096, 112, 64, 64, 4, (ALIGNED,) * 2).chunk == \
        sc.CHUNK
    with pytest.raises(ValueError, match="shared memory"):
        sc.plan_ssd(1, 64, 2, 256, 256, 4, (ALIGNED,) * 2)


# ------------------------------------------------------ operand validation
@pytest.mark.parametrize("kernel,operands,bad", [
    ("decode_attention", {"q": (4, 16), "k": (32, 2, 16),
                          "v": (32, 2, 16)}, "k"),
    ("decode_attention", {"q": (4, 16), "k": (32, 2, 16),
                          "v": (32, 2, 16)}, "q"),
    ("ssd_chunk_scan", {"x": (1, 2, 3, 4), "b": (1, 2, 8), "c": (1, 2, 8),
                        "dt": (1, 2, 3), "a": (3,),
                        "state0": (1, 3, 4, 8)}, "state0"),
    ("ssd_chunk_scan", {"x": (1, 2, 3, 4), "b": (1, 2, 8), "c": (1, 2, 8),
                        "dt": (1, 2, 3), "a": (3,),
                        "state0": (1, 3, 4, 8)}, "c")])
def test_a_strided_operand_is_refused_by_name(kernel, operands, bad):
    tensors = {name: torch.zeros(shape) for name, shape in operands.items()}
    build.require_contiguous(kernel, **tensors)          # all dense: passes
    wide = list(operands[bad])
    wide[-1] *= 2
    tensors[bad] = torch.zeros(wide)[..., ::2]           # a strided view
    assert tuple(tensors[bad].shape) == operands[bad]
    with pytest.raises(ValueError, match=f"{kernel}: operand {bad} "):
        build.require_contiguous(kernel, **tensors)
