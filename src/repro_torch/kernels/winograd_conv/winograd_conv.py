"""Winograd F(2x2, 3x3) convolution around a hand-written CUDA kernel.

This is the paper's kernel-selection case study (Fig. 6b): TFLite switches
3x3 convolutions to a Winograd kernel above C_out >= 128.  As in the JAX
package, the input, filter and inverse tile transforms are tensor code,
and the hot spot — 16 independent (P, C_in) x (C_in, C_out) products in
the Hadamard domain — is one kernel launch, `hadamard_matmul`.  It
replaces the TPU kernel
`src/repro/kernels/winograd_conv/winograd_conv.py:hadamard_matmul`.

Bound on an H100: fp32 operations outside the tensor cores (2*16*P*K*N),
or at the smallest K about as much by the bytes of U and M.  Design
(`csrc/hadamard_matmul.cu`): the Winograd point is `blockIdx.z`; each
block computes a 128 x 128, 128 x 64 or 64 x 128 tile of M[g], 8 x 8
outputs per thread in registers, from 16-deep K slices that a three-stage
ring of `cp.async` copies keeps in flight.  `plan_hadamard` is the host
half: the tile per shape and whether the 16-byte copies are aligned.
`launch=` (a "conv" `kernels.tiles.Launch`) fixes the tile instead; an
illegal one raises ValueError.

`hadamard_matmul` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it checks `launch` and computes
`hadamard_matmul_plain`, the same products written out in plain PyTorch.
`hadamard_matmul.launches` counts launches.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build, tiles

# F(2x2, 3x3) transform matrices (Lavin & Gray 2016)
_BT = np.array([[1, 0, -1, 0],
                [0, 1, 1, 0],
                [0, -1, 1, 0],
                [0, 1, 0, -1]], np.float32)
_G = np.array([[1, 0, 0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0, 0, 1]], np.float32)
_AT = np.array([[1, 1, 1, 0],
                [0, 1, -1, -1]], np.float32)


def hadamard_matmul_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M[g] = U[g] @ V[g], one 2-D product per Winograd point, accumulated
    in float32 and rounded once to u's dtype (the kernel's arithmetic)."""
    return torch.stack([u[g].float() @ v[g].float()
                        for g in range(u.shape[0])]).to(u.dtype)


#: the kernel's tiles, (rows, columns) of M[g] per block, and how many
#: blocks of each an SM holds at once (the kernel's launch bounds)
TILES = tiles.HADAMARD_TILES


@dataclass(frozen=True)
class HadamardPlan:
    """How one `hadamard_matmul` call is launched: a `bm` x `bn` tile of
    M[g] per block on a (N / bn, P / bm, G) grid; `vec`: 16-byte
    `cp.async` copies (else scalar staging)."""
    bm: int
    bn: int
    vec: bool
    grid: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def plan_hadamard(g: int, p: int, k: int, n: int, elt: int, ptrs,
                  sms: int, launch: tiles.Launch = None) -> HadamardPlan:
    """The launch of G products (P, K) @ (K, N) of `elt`-byte elements,
    the operands and the output at addresses `ptrs`, on `sms` SMs.  Every
    thread computes 8 x 8 outputs whatever the tile.  The busiest SM runs
    its ceil(blocks / sms) blocks in rounds of the tile's resident count,
    and a round takes about as long however many of its slots are filled,
    so a tile costs rounds x resident x its area; the cheapest wins, the
    larger tile on a tie (fewer shared-memory reads per product).  A
    validated `launch` that names a tile takes it instead."""
    def cost(tile):
        (bm, bn), resident = tile, TILES[tile]
        busiest = -(-(g * -(-p // bm) * -(-n // bn)) // sms)
        return -(-busiest // resident) * resident * bm * bn, -bm * bn
    if launch is not None and not launch.is_default:
        bm, bn = launch.get("bm"), launch.get("bn")
    else:
        bm, bn = min(TILES, key=cost)
    vec = all(ptr % 16 == 0 for ptr in ptrs) and (k * elt) % 16 == 0 \
        and (n * elt) % 16 == 0
    return HadamardPlan(bm, bn, vec, (-(-n // bn), -(-p // bm), g))


@functools.lru_cache(maxsize=None)
def _launcher():
    return build.entry_point("hadamard_matmul", "hadamard_matmul_launch",
                             n_ptr=3, n_int=7)


def hadamard_matmul(u: torch.Tensor, v: torch.Tensor, *,
                    launch=None) -> torch.Tensor:
    """M[g] = U[g] @ V[g] for every g.  u: (G, P, K); v: (G, K, N) ->
    (G, P, N) in u's dtype.  `launch`: None (the planner's tile), or a
    "conv" `Launch` (or mapping) legal for this call."""
    if u.dim() != 3 or v.dim() != 3 or u.shape[0] != v.shape[0] \
            or u.shape[2] != v.shape[1]:
        raise ValueError(f"hadamard_matmul needs u (G, P, K) and v (G, K, N),"
                         f" got {tuple(u.shape)} and {tuple(v.shape)}")
    g, p, k = u.shape
    n = v.shape[2]
    launch = tiles.check_launch("conv", launch, {"p": p, "k": k, "n": n})
    if u.device.type == "cpu" and v.device.type == "cpu":
        return hadamard_matmul_plain(u, v)
    code = build.dtype_code("hadamard_matmul", u, v)
    if -(-p // 64) > 65535 or g > 65535:
        raise ValueError(f"hadamard_matmul grid too large for P={p}, G={g}")
    dev = u.device
    out = torch.empty((g, p, n), dtype=u.dtype, device=dev)
    plan = plan_hadamard(g, p, k, n, u.element_size(),
                         (u.data_ptr(), v.data_ptr(), out.data_ptr()),
                         build.sm_count(dev.index), launch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(dev.index, code, u.data_ptr(), v.data_ptr(),
                      out.data_ptr(), g, p, k, n, plan.bm, plan.bn,
                      int(plan.vec), stream)
    if err:
        raise RuntimeError(f"hadamard_matmul launch failed with CUDA error "
                           f"{err} (u {tuple(u.shape)}, v {tuple(v.shape)}, "
                           f"{plan})")
    hadamard_matmul.launches += 1
    return out


hadamard_matmul.launches = 0


@functools.lru_cache(maxsize=None)
def _transform(name: str, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """A transform matrix on `device`, copied there once: a copy from host
    memory per call would make the host wait for the stream each time."""
    mats = {"BT": _BT, "G": _G, "AT": _AT}
    return torch.as_tensor(mats[name], dtype=dtype, device=device)


def winograd_operands(x: torch.Tensor, w: torch.Tensor):
    """The Hadamard-domain operands of a 3x3 SAME conv: U = B^T d B of the
    input tiles, (16, P, C_in) with P ordered (b, th, tw), and V = G g G^T
    of the filter, (16, C_in, C_out)."""
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"winograd_conv2d takes 3x3 filters, got {kh}x{kw}")
    th, tw = -(-h // 2), -(-wd // 2)      # 2x2 output tiles

    # pad: 1 halo + tile remainder; then 4x4 input tiles at stride 2,
    # (B, th, tw, C, 4, 4) with the last two axes (row, column)
    xp = F.pad(x, (0, 0, 1, 2 * tw - wd + 1, 1, 2 * th - h + 1))
    patches = xp.unfold(1, 4, 2).unfold(2, 4, 2)
    bt = _transform("BT", x.device, x.dtype)
    u = torch.einsum("ij,bhwcjk,lk->ilbhwc", bt, patches, bt)
    u = u.reshape(16, b * th * tw, cin).contiguous()
    gm = _transform("G", w.device, w.dtype)
    v = torch.einsum("ij,jkcn,lk->ilcn", gm, w, gm)
    return u, v.reshape(16, cin, cout).contiguous()


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                    launch=None) -> torch.Tensor:
    """3x3 stride-1 SAME conv via F(2x2,3x3).

    x: (B, H, W, C_in); w: (3, 3, C_in, C_out) -> (B, H, W, C_out).
    `launch` goes to `hadamard_matmul` as it is.
    """
    b, h, wd, _ = x.shape
    cout = w.shape[3]
    th, tw = -(-h // 2), -(-wd // 2)
    u, v = winograd_operands(x, w)
    m = hadamard_matmul(u, v, launch=launch)

    # inverse transform y = A^T M A over each 4x4 tile
    m = m.reshape(4, 4, b, th, tw, cout)
    at = _transform("AT", m.device, m.dtype)
    y = torch.einsum("ij,jkbhwc,lk->bhiwlc", at, m, at)
    y = y.reshape(b, 2 * th, 2 * tw, cout)
    return y[:, :h, :wd, :].contiguous()
