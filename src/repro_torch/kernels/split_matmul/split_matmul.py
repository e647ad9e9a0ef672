"""Hand-written CUDA kernel: channel-partitioned matmul (the co-execution
primitive).

Computes Y = X @ W[:, c0 : c0 + width] — one compute group's share of a
channel-split linear layer (paper Section 2, Fig. 4).  It replaces the TPU
kernel `src/repro/kernels/split_matmul/split_matmul.py:split_matmul`.

Bound on an H100: at batch 1 the product is a matrix-vector product that
streams W once, so it is bound by the bytes of W (VGG16's first FC layer
reads 411 MB).  Design (`csrc/split_matmul.cu`), for M <= 8: a split-K
GEMV.  Each block reads a tile of W's columns over one chunk of K with
16-byte loads (a warp covers one 512-byte row segment), the grid is
(column tiles) x (K splits) sized to one full wave of the blocks the card
holds at once, and the splits' fp32 partials are summed in a fixed order
by a second small kernel, so a call's result is bit-identical from call
to call.  `plan_launch` is the host half of that design: it picks the variant
(16-byte or scalar loads, from the actual pointer's alignment), the rows
of X a block holds, the column tile, the number of splits and the K chunk.
M > 8 takes a tiled product, 64 x 64 by default (128 x 64, 64 x 128 and
128 x 128 blocks are instantiated too).

`launch=` (a `kernels.tiles.Launch`, or None for the planner's choice)
fixes the GEMV's split-K factor `splits` or the tiled product's block
`bm` x `bn`; an explicit value is validated against the call and raises
ValueError where it is illegal, never rewritten (`kernels.tiles`).

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
#: tiled product for M > 8
VECTOR, SCALAR, TILED = 0, 1, 2

#: the most rows of X the GEMV holds per block
MAX_GEMV_ROWS = tiles.MAX_GEMV_ROWS
#: a block streams no less W than this (~32 KB), however small the grid
MIN_BLOCK_BYTES = 24 * 1024
#: shared memory for a block's slice of X (fp32, rows x K chunk)
X_STAGE_BYTES = 32 * 1024


@dataclass(frozen=True)
class LaunchPlan:
    """How one `split_matmul` call is launched.  `mt`: rows of X a block
    holds (for the GEMV a power of two >= M); `tile`: columns per block;
    `splits`: blocks along K, split s covering rows
    [s * k_chunk, min(K, (s + 1) * k_chunk))."""
    variant: int
    mt: int
    tile: int
    col_tiles: int
    splits: int
    k_chunk: int

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.splits

    def k_ranges(self, k: int):
        """The (begin, end) rows of K each split reads."""
        return [(s * self.k_chunk, min(k, (s + 1) * self.k_chunk))
                for s in range(self.splits)]


def gemv_variant(m: int, n: int, c0: int, elt: int, w_ptr: int) -> int:
    """TILED for M > 8; else VECTOR where W[0, c0] (at `w_ptr` + c0 * elt)
    and the row pitch N * elt are 16-byte aligned, SCALAR otherwise."""
    if m > MAX_GEMV_ROWS:
        return TILED
    aligned = (w_ptr + c0 * elt) % 16 == 0 and (n * elt) % 16 == 0
    return VECTOR if aligned else SCALAR


def gemv_rows(m: int) -> int:
    """The rows of X a GEMV block holds: 1, 2, 4 or 8."""
    return 1 << max(0, m - 1).bit_length()


def plan_launch(m: int, k: int, n: int, c0: int, width: int, elt: int,
                w_ptr: int, sms: int, resident: int,
                launch: tiles.Launch = None) -> LaunchPlan:
    """The launch of Y (m, width) = X (m, k) @ W (k, n)[:, c0:c0+width] for
    elements of `elt` bytes, W's data at address `w_ptr`, on a card of
    `sms` SMs that each hold `resident` GEMV blocks at once.  K is split
    so that the grid is one full wave (at most resident * sms blocks, and
    within one column tile's worth of it), no block streams less than
    MIN_BLOCK_BYTES of W, and a block's slice of X fits X_STAGE_BYTES.
    A validated `launch` fixes the splits or the tiled product's block
    instead."""
    fixed = {} if launch is None else launch.as_dict()
    variant = gemv_variant(m, n, c0, elt, w_ptr)
    if variant == TILED:
        bm, bn = fixed.get("bm", 64), fixed.get("bn", 64)
        return LaunchPlan(TILED, bm, bn, -(-width // bn), 1, max(1, k))
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


def plan_call(x: torch.Tensor, w: torch.Tensor, c0: int, width: int,
              launch: tiles.Launch = None) -> LaunchPlan:
    """`plan_launch` for these CUDA operands: W's actual address, the
    device's SMs and the instantiation's resident blocks."""
    m, k = x.shape
    n = w.shape[1]
    elt = x.element_size()
    dev = x.device.index
    variant = gemv_variant(m, n, c0, elt, w.data_ptr())
    resident = (1 if variant == TILED else resident_blocks(
        dev, build.dtype_code("split_matmul", x, w), variant, gemv_rows(m)))
    return plan_launch(m, k, n, c0, width, elt, w.data_ptr(),
                       build.sm_count(dev), resident, launch)


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
