"""Hand-written CUDA kernel: channel-partitioned matmul (the co-execution
primitive).

Computes Y = X @ W[:, c0 : c0 + width] — one compute group's share of a
channel-split linear layer (paper Section 2, Fig. 4).  It replaces the TPU
kernel `src/repro/kernels/split_matmul/split_matmul.py:split_matmul`.

Two designs (`csrc/split_matmul.cu`), both summing in fp32 and rounding
once to the dtype:

* M <= 8, a split-K GEMV.  At batch 1 the product streams W once, so it is
  bound by the bytes of W (VGG16's first FC layer reads 411 MB).  Each
  block reads a tile of W's columns over one chunk of K with 16-byte loads
  (a warp covers one 512-byte row segment), the grid is (column tiles) x
  (K splits) sized to one full wave of the blocks the card holds at once.
* M > 8, a tiled product on the tensor cores (rwkv6-1.6b's prefill plan
  runs it at M = 512): bound by operations.  bf16 takes mma.sync
  m16n8k16; fp32 takes m16n8k8 in TF32 with the 3xTF32 split (three TF32
  products, accurate to fp32's tolerance).  A block of 8 warps owns a
  bm x bn tile of Y (64 or 128 each way) and walks its K chunk in
  `GEMM_BK`-row steps through a ring of shared-memory stages filled by
  16-byte `cp.async` copies (element loads where a pointer or pitch is not
  16-byte aligned: `TILED_NARROW`).  K is split in whole steps so that the
  grid is about one wave of the blocks an SM holds.

Either design writes split partials in fp32 to a workspace, and a second
small kernel sums them in a fixed order, so a call's result is
bit-identical from call to call.  `plan_launch` is the host half: the
variant (from the actual pointers' alignment), the rows of X a block holds
(`mt`), its columns (`tile`), the number of splits and the K chunk.

`launch=` (a `kernels.tiles.Launch`, or None for the planner's choice)
fixes the split-K factor `splits` or the tiled product's block `bm` x
`bn`; an explicit value is validated against the call and raises
ValueError where it is illegal, never rewritten (`kernels.tiles`).  A
block named without `splits` keeps the split the planner picks for the
call, so every block gives the same bits.

`split_matmul` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it checks `launch` and computes
`split_matmul_plain`, the same function in plain PyTorch.
`split_matmul.launches` counts launches (one per call, whether or not the
call needs the reduction pass).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, tiles
from repro_torch.kernels.split_matmul.ref import split_matmul_ref

#: the plain PyTorch version of the kernel's function
split_matmul_plain = split_matmul_ref


#: variants of the launch: 16-byte loads, scalar loads (M <= 8), and the
#: tiled product for M > 8 with 16-byte cp.async staging or element loads
VECTOR, SCALAR, TILED, TILED_NARROW = 0, 1, 2, 3

#: the most rows of X the GEMV holds per block
MAX_GEMV_ROWS = tiles.MAX_GEMV_ROWS
#: a block streams no less W than this (~32 KB), however small the grid
MIN_BLOCK_BYTES = 24 * 1024
#: shared memory for a block's slice of X (fp32, rows x K chunk)
X_STAGE_BYTES = 32 * 1024

#: the tiled product's blocks (bm, bn) and its K step
GEMM_BLOCKS = tuple((bm, bn) for bm in tiles.GEMM_EDGES
                    for bn in tiles.GEMM_EDGES)
GEMM_BK = tiles.GEMM_BK
#: the fewest K steps a split chunk takes: a shorter one spends most of its
#: time filling the ring
MIN_SPLIT_STEPS = 2
#: the planner's pace of the tiled product on an H100 SXM, from the launch
#: sweep of `chip_smoke.py --split-times`: multiply-adds a microsecond of
#: one SM busy with 128 x 128 blocks, by element size (fp32 as 3xTF32,
#: bf16); the other blocks' pace relative to that; the reduction pass's
#: fixed microseconds and partial bytes a microsecond
TILED_MACS_PER_US = {4: 218e3, 2: 795e3}
TILED_BLOCK_PACE = {(128, 128): 1.0, (128, 64): 0.83, (64, 128): 0.83,
                    (64, 64): 0.7}
REDUCE_US = 2.0
REDUCE_BYTES_PER_US = 2.5e6


@dataclass(frozen=True)
class LaunchPlan:
    """How one `split_matmul` call is launched.  `mt`: rows of X a block
    holds (for the GEMV a power of two >= M, for the tiled product bm);
    `tile`: columns per block; `row_tiles`: blocks along M (the tiled
    product); `splits`: blocks along K, split s covering rows
    [s * k_chunk, min(K, (s + 1) * k_chunk))."""
    variant: int
    mt: int
    tile: int
    col_tiles: int
    splits: int
    k_chunk: int
    row_tiles: int = 1

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.row_tiles * self.splits

    def k_ranges(self, k: int):
        """The (begin, end) rows of K each split reads."""
        return [(s * self.k_chunk, min(k, (s + 1) * self.k_chunk))
                for s in range(self.splits)]


def load_variant(m: int, n: int, c0: int, elt: int, w_ptr: int, k: int = 0,
                 x_ptr: int = 0) -> int:
    """The load variant, from the actual pointers: for M <= 8 VECTOR where
    W[0, c0] (at `w_ptr` + c0 * elt) and the row pitch N * elt are
    16-byte aligned, SCALAR otherwise; for M > 8 TILED where X (at
    `x_ptr`, row pitch K * elt) is 16-byte aligned too, TILED_NARROW
    otherwise."""
    aligned = (w_ptr + c0 * elt) % 16 == 0 and (n * elt) % 16 == 0
    if m > MAX_GEMV_ROWS:
        aligned = aligned and x_ptr % 16 == 0 and (k * elt) % 16 == 0
        return TILED if aligned else TILED_NARROW
    return VECTOR if aligned else SCALAR


def gemv_rows(m: int) -> int:
    """The rows of X a GEMV block holds: 1, 2, 4 or 8."""
    return 1 << max(0, m - 1).bit_length()


def _blocks_of(resident, bm: int, bn: int) -> int:
    """Tiled blocks of bm x bn an SM holds: `resident` is one count for
    every block or a mapping {(bm, bn): count}."""
    return resident if isinstance(resident, int) else resident[(bm, bn)]


def tiled_splits(k: int, tiles_: int, slots: int) -> int:
    """The most K splits of a tiled grid of `tiles_` output tiles on a card
    that holds `slots` of its blocks at once: none where the tiles alone
    fill a wave; else as many as keep the grid within one wave, each chunk
    at least MIN_SPLIT_STEPS steps where K allows, in whole GEMM_BK steps,
    none empty (`tiles.exact_splits`)."""
    if tiles_ >= slots:
        return 1
    steps = -(-k // GEMM_BK)
    want = max(1, min(slots // tiles_, steps // MIN_SPLIT_STEPS))
    return tiles.exact_splits(k, want, GEMM_BK)


def _tiled_plan(variant: int, m: int, k: int, width: int, bm: int, bn: int,
                splits: int) -> LaunchPlan:
    steps = max(1, -(-k // GEMM_BK))
    k_chunk = -(-steps // splits) * GEMM_BK
    return LaunchPlan(variant, bm, bn, -(-width // bn),
                      max(1, -(-k // k_chunk)), k_chunk, -(-m // bm))


def tiled_cost(plan: LaunchPlan, m: int, width: int, elt: int,
               sms: int) -> float:
    """The planner's model of a tiled launch's microseconds: the blocks
    the busiest SM runs, each its bm x bn x (K chunk) product at its
    block's pace; where K is split, the reduction pass besides (each
    split's fp32 partials read, Y written once)."""
    per_sm = -(-plan.blocks // sms)
    us = (per_sm * plan.mt * plan.tile * plan.k_chunk
          / (TILED_MACS_PER_US[elt] * TILED_BLOCK_PACE[(plan.mt, plan.tile)]))
    if plan.splits > 1:
        us += REDUCE_US + (4 * plan.splits + elt) * m * width \
            / REDUCE_BYTES_PER_US
    return us


def plan_tiled(variant: int, m: int, k: int, width: int, elt: int, sms: int,
               resident, fixed: dict) -> LaunchPlan:
    """The tiled product's launch: of each block a launch may name (at
    most the padded M and width) and each exact split up to one wave of
    its resident blocks (`tiled_splits`), the cheapest by `tiled_cost`.  A
    fixed `splits` keeps that block; a fixed block keeps that split, so an
    output-tiling launch sums every output as the default does."""
    best, best_us = None, None
    for bm, bn in reversed(GEMM_BLOCKS):          # ties: the larger block
        if bm > tiles.round_up(m, 64) or bn > tiles.round_up(width, 64):
            continue
        grid = -(-m // bm) * -(-width // bn)
        most = tiled_splits(k, grid, _blocks_of(resident, bm, bn) * sms)
        for splits in sorted({tiles.exact_splits(k, s, GEMM_BK)
                              for s in range(1, most + 1)}):
            plan = _tiled_plan(variant, m, k, width, bm, bn, splits)
            us = tiled_cost(plan, m, width, elt, sms)
            if best is None or us < best_us:
                best, best_us = plan, us
    bm, bn = fixed.get("bm", best.mt), fixed.get("bn", best.tile)
    return _tiled_plan(variant, m, k, width, bm, bn,
                       fixed.get("splits") or best.splits)


def plan_launch(m: int, k: int, n: int, c0: int, width: int, elt: int,
                w_ptr: int, sms: int, resident, launch: tiles.Launch = None,
                x_ptr: int = 0) -> LaunchPlan:
    """The launch of Y (m, width) = X (m, k) @ W (k, n)[:, c0:c0+width] for
    elements of `elt` bytes, W's data at address `w_ptr` (X's at `x_ptr`),
    on a card of `sms` SMs.  `resident`: the blocks of the GEMV
    instantiation an SM holds at once, or for M > 8 those of each tiled
    block (one count, or a mapping {(bm, bn): count}).  GEMV: K is split
    so that the grid is one full wave (at most resident * sms blocks, and
    within one column tile's worth of it), no block streams less than
    MIN_BLOCK_BYTES of W, and a block's slice of X fits X_STAGE_BYTES.
    Tiled product: `plan_tiled`.  A validated `launch` fixes the splits or
    the tiled product's block instead."""
    fixed = {} if launch is None else launch.as_dict()
    variant = load_variant(m, n, c0, elt, w_ptr, k, x_ptr)
    if variant in (TILED, TILED_NARROW):
        return plan_tiled(variant, m, k, width, elt, sms, resident,
                          fixed)
    tile = 32 * (16 // elt)                  # a warp's 16-byte loads
    col_tiles = -(-width // tile)
    mt = gemv_rows(m)
    want = max(1, resident * sms // col_tiles)
    most = max(1, k * tile * elt // MIN_BLOCK_BYTES)
    fewest = -(-k // (X_STAGE_BYTES // (4 * mt)))
    splits = fixed.get("splits") or max(fewest, min(want, most), 1)
    k_chunk = max(1, -(-k // splits))
    splits = max(1, -(-k // k_chunk))
    return LaunchPlan(variant, mt, tile, col_tiles, splits, k_chunk)


def resident_blocks(device_index: int, code: int, variant: int,
                    mt: int) -> int:
    """GEMV blocks of this instantiation one SM of the device holds at
    once (with the largest X stage a plan allows)."""
    return build.resident_blocks("split_matmul", "split_matmul_resident",
                                 device_index, code, variant, mt,
                                 X_STAGE_BYTES)


_TILED_RESIDENT: dict = {}


def tiled_resident(device_index: int, code: int) -> dict:
    """{variant: {(bm, bn): blocks}}: the tiled blocks of both variants one
    SM of the device holds at once.  All eight are queried (and their
    shared-memory limits set) at the first tiled call of a dtype on a
    device, so no later plan makes a runtime call for them.  That first
    call may not be made inside a CUDA graph capture (the fused walk runs
    each segment eagerly before it captures it): it raises there."""
    key = (device_index, code)
    if key not in _TILED_RESIDENT:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "split_matmul: the first tiled call of this dtype on "
                f"cuda:{device_index} is inside a CUDA graph capture; run "
                "it once eagerly first (its occupancy query and "
                "shared-memory attributes are runtime calls)")
        _TILED_RESIDENT[key] = {variant: {(bm, bn): build.resident_blocks(
            "split_matmul", "split_matmul_tiled_resident", device_index,
            code, variant, bm, bn) for bm, bn in GEMM_BLOCKS}
            for variant in (TILED, TILED_NARROW)}
    return _TILED_RESIDENT[key]


def plan_call(x: torch.Tensor, w: torch.Tensor, c0: int, width: int,
              launch: tiles.Launch = None) -> LaunchPlan:
    """`plan_launch` for these CUDA operands: X's and W's actual
    addresses, the device's SMs and the instantiation's resident
    blocks."""
    m, k = x.shape
    n = w.shape[1]
    elt = x.element_size()
    dev = x.device.index
    code = build.dtype_code("split_matmul", x, w)
    variant = load_variant(m, n, c0, elt, w.data_ptr(), k, x.data_ptr())
    if variant in (TILED, TILED_NARROW):
        resident = tiled_resident(dev, code)[variant]
    else:
        resident = resident_blocks(dev, code, variant, gemv_rows(m))
    return plan_launch(m, k, n, c0, width, elt, w.data_ptr(),
                       build.sm_count(dev), resident, launch, x.data_ptr())


@functools.lru_cache(maxsize=None)
def _launcher():
    return build.entry_point("split_matmul", "split_matmul_launch",
                             n_ptr=4, n_int=11)


def split_matmul(x: torch.Tensor, w: torch.Tensor, c0: int, width: int, *,
                 launch=None) -> torch.Tensor:
    """Y = X @ W[:, c0:c0+width]; x (M, K), w (K, N) -> (M, width) in x's
    dtype, accumulated in float32.  `launch`: None (the planner's choice),
    or a "linear" `Launch` (or mapping) legal for this call."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"split_matmul needs x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if not (0 <= c0 and width > 0 and c0 + width <= n):
        raise ValueError(f"split_matmul slice [{c0}, {c0 + width}) is not "
                         f"inside the {n} columns of w")
    launch = tiles.check_launch("linear", launch,
                                {"m": m, "k": k, "n": width})
    if x.device.type == "cpu" and w.device.type == "cpu":
        return split_matmul_plain(x, w, c0, width)
    code = build.dtype_code("split_matmul", x, w)
    dev = x.device
    plan = plan_call(x, w, c0, width, launch)
    y = torch.empty((m, width), dtype=x.dtype, device=dev)
    # on the current stream: inside a group's scope that is the side's own
    ws = (torch.empty((plan.splits, m, width), dtype=torch.float32,
                      device=dev) if plan.splits > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(dev.index, code, x.data_ptr(), w.data_ptr(),
                      y.data_ptr(), None if ws is None else ws.data_ptr(),
                      m, k, n, c0, width, plan.variant, plan.mt,
                      plan.tile, plan.col_tiles, plan.splits, plan.k_chunk,
                      stream)
    if err:
        raise RuntimeError(f"split_matmul launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"c0 {c0}, width {width}, {plan})")
    split_matmul.launches += 1
    return y


split_matmul.launches = 0
