"""The SSD chunk kernels' design against the JAX package's kernel, on the CPU.

For T > DECODE_T_MAX `ssd_chunk_scan` launches three CUDA kernels
(`csrc/ssd_chunk.cu`): `ssd_chunk_state` (each chunk's own end state and
decay), `ssd_chunk_pass` (the chunks' incoming states, in order) and
`ssd_chunk_out` (the outputs, with C B^T shared by a block's heads), every
product on the tensor cores in 3xTF32.  `_ssd_chunk_mirror` is those three
phases in plain PyTorch, with TF32 rounding (cvt.rna) emulated on the fp32
bits (the kernels truncate) and each product the kernels' three TF32
products.  It is held against
the reference's Pallas kernel (`interpret=True`) and its step-by-step scan
at ragged T and at zamba2-7b's head widths, within the fp32 tolerance the
card holds the kernels to (`chip_smoke.KERNEL_RTOL`); one TF32 product
alone is shown to miss it.  The chunk kernels' launch plans are checked
here too: their grids, head groups, workspace and shared memory.
"""
import importlib
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.kernels.ssd_chunk.ssd_chunk import (
    ssd_chunk_scan as jax_ssd_chunk_scan)

from repro_torch.kernels import build, tiles
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan_plain

sc = importlib.import_module("repro_torch.kernels.ssd_chunk.ssd_chunk")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: kernel vs reference, relative to the largest |reference| value
RTOL = chip_smoke.KERNEL_RTOL[torch.float32]

ALIGNED = 0x7f0000000000         # a 16-byte-aligned device address


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """The kernels' `tf32`: v's fp32 bits with the 13 low mantissa bits
    cleared (truncation to TF32's 10 mantissa bits)."""
    bits = v.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor, splits: int = 3) -> torch.Tensor:
    """a @ b as the kernels take it on the tensor cores: each fp32 operand
    split into big = tf32(v) and small = tf32(v - big), and small big +
    big small + big big summed in fp32 (small small dropped); `splits=1`
    is one TF32 product, big big alone."""
    ab, bb = _tf32(a), _tf32(b)
    if splits == 1:
        return ab @ bb
    al, bl = _tf32(a - ab), _tf32(b - bb)
    return al @ bb + ab @ bl + ab @ bb


def _ssd_chunk_mirror(x, b, c, dt, a, state0, chunk=sc.CHUNK, splits=3):
    """The chunk kernels in plain PyTorch (fp32), chunks of `chunk` tokens,
    the last one ragged; returns (final state, y)."""
    xf, bf, cf, dtf, af, h = (torch.as_tensor(u).float()
                              for u in (x, b, c, dt, a, state0))
    t = xf.shape[1]
    bounds = [(t0, min(t, t0 + chunk)) for t0 in range(0, t, chunk)]
    # ssd_chunk_state: each chunk's own end state S_c and decay exp(l_L)
    ls, states, decays = [], [], []
    for t0, t1 in bounds:
        l = torch.cumsum(dtf[:, t0:t1] * af, dim=1)              # (B, n, H)
        w = dtf[:, t0:t1] * torch.exp(l[:, -1:] - l)   # dt_j exp(l_L - l_j)
        xw = (xf[:, t0:t1] * w[..., None]).permute(0, 2, 3, 1)  # (B,H,hd,n)
        states.append(_mm3(xw, bf[:, None, t0:t1], splits))     # (B,H,hd,N)
        decays.append(torch.exp(l[:, -1]))                       # (B, H)
        ls.append(l.permute(0, 2, 1))                            # (B, H, n)
    # ssd_chunk_pass: each chunk's incoming state, in order
    h_in = []
    for s_c, d_c in zip(states, decays):
        h_in.append(h)
        h = d_c[..., None, None] * h + s_c
    # ssd_chunk_out: C B^T once per (batch, chunk), shared by the heads
    ys = []
    for (t0, t1), l, hc in zip(bounds, ls, h_in):
        n = t1 - t0
        cc = cf[:, t0:t1]
        cb = _mm3(cc, bf[:, t0:t1].transpose(1, 2), splits)     # (B, n, n)
        ce = cc[:, None] * torch.exp(l)[..., None]               # (B,H,n,N)
        y = _mm3(ce, hc.transpose(2, 3), splits)                 # (B,H,n,hd)
        causal = torch.ones(n, n, dtype=torch.bool).tril()
        wmat = torch.where(causal, cb[:, None] * torch.exp(
            l[..., :, None] - l[..., None, :]), torch.zeros(()))
        xdt = (xf[:, t0:t1] * dtf[:, t0:t1, :, None]).permute(0, 2, 1, 3)
        ys.append((y + _mm3(wmat, xdt, splits)).permute(0, 2, 1, 3))
    return h, torch.cat(ys, dim=1)


def _inputs(b, t, h, hd, n, seed):
    """The decode kernels' tests' draw: unit-normal x, B, C and state,
    dt in [0.01, 0.5), a in (-1.5, -0.1]."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, t, h, hd)).astype(f),
            rng.standard_normal((b, t, n)).astype(f),
            rng.standard_normal((b, t, n)).astype(f),
            rng.uniform(0.01, 0.5, size=(b, t, h)).astype(f),
            -rng.uniform(0.1, 1.5, size=(h,)).astype(f),
            rng.standard_normal((b, h, hd, n)).astype(f))


def _rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_chunk(t: int) -> int:
    """The reference kernel's chunk for T: its default 256 where that
    divides T, else the largest divisor of T up to 128 (its chunk must
    divide T)."""
    if t % 256 == 0:
        return 256
    return max(d for d in range(1, min(t, 128) + 1) if t % d == 0)


# (B, T, H, hd, N): ragged last chunks (T = 17, 65, 100, 300), whole ones
# (64, 512), narrow and odd widths, and zamba2-7b's head (hd = N = 64)
CASES = [
    (2, 17, 3, 20, 12),
    (1, 64, 2, 32, 16),
    (2, 65, 3, 32, 16),
    (1, 100, 2, 20, 12),
    (2, 300, 3, 32, 16),
    (1, 512, 3, 64, 64),
]


@pytest.mark.parametrize("chunk", [sc.CHUNK, 16, tiles.SSD_MAX_CHUNK])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}t{}h{}hd{}n{}"
                         .format(*c))
def test_ssd_chunk_mirror_matches_reference(case, chunk):
    ins = _inputs(*case, seed=sum(case))
    sf, y = _ssd_chunk_mirror(*ins, chunk=chunk)
    sf_k, y_k = jax_ssd_chunk_scan(*map(jnp.asarray, ins),
                                   chunk=_jax_chunk(case[1]),
                                   interpret=True)
    assert _rel_err(y, y_k) <= RTOL
    assert _rel_err(sf, sf_k) <= RTOL
    sf_r, y_r = jax_ssd_scan_ref(*map(jnp.asarray, ins))
    assert _rel_err(y, y_r) <= RTOL
    assert _rel_err(sf, sf_r) <= RTOL


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}t{}h{}hd{}n{}"
                         .format(*c))
def test_ssd_chunk_mirror_matches_the_plain_version(case):
    """The oracle the card holds the kernels against, chunked alike."""
    ins = _inputs(*case, seed=sum(case) + 1)
    sf, y = _ssd_chunk_mirror(*ins)
    sf_p, y_p = ssd_chunk_scan_plain(*map(torch.tensor, ins))
    assert _rel_err(y, y_p) <= RTOL
    assert _rel_err(sf, sf_p) <= RTOL


@pytest.mark.parametrize("case", CASES[2:], ids=lambda c: "b{}t{}h{}hd{}n{}"
                         .format(*c))
def test_ssd_chunk_mirror_of_bf16_inputs_matches_reference(case):
    """bf16 operands are widened to fp32 before the split, as the kernels
    load them."""
    ins = tuple(torch.tensor(u).bfloat16().float().numpy()
                for u in _inputs(*case, seed=sum(case) + 2))
    sf, y = _ssd_chunk_mirror(*ins)
    sf_r, y_r = jax_ssd_scan_ref(*map(jnp.asarray, ins))
    assert _rel_err(y, y_r) <= RTOL
    assert _rel_err(sf, sf_r) <= RTOL


def test_one_tf32_product_misses_the_tolerance_that_three_hold():
    """Why 3xTF32: at zamba2-7b's head widths one TF32 product per sum
    (~11 bits) is off by more than the fp32 tolerance."""
    ins = _inputs(1, 512, 3, 64, 64, seed=7)
    _, y_r = jax_ssd_scan_ref(*map(jnp.asarray, ins))
    _, y3 = _ssd_chunk_mirror(*ins)
    _, y1 = _ssd_chunk_mirror(*ins, splits=1)
    assert _rel_err(y3, y_r) <= RTOL < _rel_err(y1, y_r)


@pytest.mark.parametrize("v,want", [
    (1.0, 1.0),
    (1 + 2 ** -10, 1 + 2 ** -10),          # TF32's last mantissa bit
    (1 + 2 ** -11, 1.0),                   # truncated, not rounded
    (-(1 + 2 ** -10 + 2 ** -11), -(1 + 2 ** -10)),   # towards zero
    (3 * 2 ** -12 + 2 ** -21, 3 * 2 ** -12 + 2 ** -21),
    (3 * 2 ** -12 + 2 ** -22, 3 * 2 ** -12),
])
def test_tf32_truncates_the_low_mantissa_bits(v, want):
    assert float(_tf32(torch.tensor([v], dtype=torch.float32))) == want


def test_the_tf32_split_keeps_20_bits():
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        10000).astype(np.float32))
    big = _tf32(v)
    small = _tf32(v - big)
    assert torch.all(big.view(torch.int32) & 0x1fff == 0)
    assert torch.all(small.view(torch.int32) & 0x1fff == 0)
    assert torch.all((v - big).abs() < v.abs() * 2.0 ** -10)
    assert torch.all((v - big - small).abs() < v.abs() * 2.0 ** -20)


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("b,t,h,hd,n,elt", [
    (2, 512, 112, 64, 64, 4), (4, 512, 112, 64, 64, 4),
    (1, 4096, 112, 64, 64, 4), (4, 512, 112, 64, 64, 2),
    (1, 512, 112, 64, 64, 4), (2, 100, 6, 32, 16, 4), (1, 17, 5, 20, 12, 2),
    (3, 300, 7, 130, 24, 4), (1, 1, 4, 16, 300, 4)])
def test_ssd_chunk_grids_cover_every_chunk_and_head(b, t, h, hd, n, elt):
    plan = sc.plan_ssd(b, t, h, hd, n, elt, (ALIGNED,) * 2)
    assert plan.variant == sc.CHUNKED
    nc, groups, batch = plan.grid
    assert nc * plan.chunk >= t > (nc - 1) * plan.chunk
    assert groups * plan.heads >= h > (groups - 1) * plan.heads
    assert batch == b and plan.blocks == nc * groups * b
    assert plan.heads in sc.HEAD_GROUPS or plan.heads == h
    # the pass walks every state element once
    per = sc.PASS_ELEMS if (hd * n) % sc.PASS_ELEMS == 0 else 1
    assert plan.pass_blocks == math.ceil(b * h * hd * n
                                         / (per * sc.PASS_THREADS))


@pytest.mark.parametrize("b,t,h,hd,n,chunk", [
    (4, 512, 112, 64, 64, None), (1, 4096, 112, 64, 64, 128),
    (2, 100, 6, 32, 16, 16), (1, 17, 2, 20, 12, None)])
def test_ssd_chunk_workspace_holds_every_chunk_state_and_decay(b, t, h, hd,
                                                               n, chunk):
    plan = sc.plan_ssd(b, t, h, hd, n, 4, (ALIGNED,) * 2, chunk)
    nc = math.ceil(t / plan.chunk)
    assert plan.workspace == 4 * (b * h * nc * hd * n + b * h * nc)
    # zamba2-7b at B = 4, T = 512, L = 64: as large as x in fp32
    if (b, t, chunk) == (4, 512, None):
        assert plan.workspace - 4 * b * h * nc == 4 * b * t * h * hd


def test_ssd_chunk_head_groups_fill_the_card():
    """A group of 4 heads where the grid still gives each SM two blocks,
    fewer where it would not."""
    def heads(b, t):
        return sc.plan_ssd(b, t, 112, 64, 64, 4, (ALIGNED,) * 2).heads
    assert heads(4, 512) == heads(2, 512) == heads(1, 4096) == 4
    assert heads(1, 512) == 2
    assert heads(1, 64) == 1
    # a group never holds more heads than there are
    assert sc.plan_ssd(1, 64, 3, 64, 64, 4, (ALIGNED,) * 2,
                       sms=0).heads == 3


def test_ssd_chunk_shared_memory_is_the_kernels_layout():
    # zamba2-7b fp32, L = 64, 4 heads, out block: C (64 x 72), C B^T
    # (64 x 72) fp32, two buffers of an x tile (64 x 68) and an h_in tile
    # (64 x 72) fp32, three (4, 64) fp32 vectors
    assert tiles.ssd_out_smem(64, 64, 4, 4) == 4 * (
        64 * 72 + 64 * 72 + 2 * (64 * 68 + 64 * 72) + 3 * 4 * 64)
    # bf16: C and x rows padded by 8 elements; B (64 x 72) fits buffer 2
    assert tiles.ssd_out_smem(64, 64, 2, 4) == (
        2 * 64 * 72 + 4 * 64 * 72 + 2 * (2 * 64 * 72 + 4 * 64 * 72)
        + 4 * 3 * 4 * 64)
    # state block: B^T's two TF32 parts (64 x 72 words each), two x tiles
    # of which the second holds B as staged (64 x 72) until it is split,
    # two (4, 64) fp32 vectors
    assert tiles.ssd_state_smem(64, 64, 4, 4) == 4 * (
        2 * 64 * 72 + 64 * 68 + 64 * 72 + 2 * 4 * 64)
    # a ragged chunk and N are padded to whole 16-row and 8-wide tiles
    assert tiles.ssd_state_smem(12, 17, 4, 1) == tiles.ssd_state_smem(
        16, 32, 4, 1)
    plan = sc.plan_ssd(4, 512, 112, 64, 64, 4, (ALIGNED,) * 2)
    assert (plan.smem, plan.smem_state) == (tiles.ssd_out_smem(64, 64, 4, 4),
                                            tiles.ssd_state_smem(64, 64, 4, 4))
    # two out blocks and three state blocks fit an SM's 228 KB (1 KB of
    # each block's is the system's)
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    assert 3 * (plan.smem_state + 1024) <= 228 * 1024


@pytest.mark.parametrize("hd,n,elt,ptrs,vec", [
    (64, 64, 4, (ALIGNED,) * 3, True),
    (64, 64, 2, (ALIGNED,) * 3, True),
    (64, 64, 4, (ALIGNED, ALIGNED + 4, ALIGNED), False),   # an odd B
    (20, 12, 4, (ALIGNED,) * 3, True),     # 48-byte N rows, 80-byte hd
    (20, 12, 2, (ALIGNED,) * 3, False),    # 24-byte N rows
    (20, 16, 2, (ALIGNED,) * 3, False),    # 40-byte hd rows
    (32, 16, 4, (ALIGNED,) * 3, True),
])
def test_ssd_chunk_stages_16_bytes_only_where_aligned(hd, n, elt, ptrs, vec):
    plan = sc.plan_ssd(1, 100, 4, hd, n, elt, (ALIGNED,) * 2,
                       stage_ptrs=ptrs)
    assert plan.vec == vec


@pytest.mark.parametrize("t,hd,n,chunk,match", [
    (512, 64, 512, None, "shared memory"),     # N too wide for a block
    (64, 256, 256, None, "shared memory"),
    (512, 64, 64, 256, "at most|over the"),    # longer than 8 row tiles
])
def test_ssd_chunk_that_does_not_fit_raises(t, hd, n, chunk, match):
    with pytest.raises(ValueError, match=match):
        sc.plan_ssd(1, t, 2, hd, n, 4, (ALIGNED,) * 2, chunk)


def test_ssd_chunk_launch_table_is_the_kernels_limit():
    spec = tiles.launch_spec("ssm")
    ext = {"t": 512, "hd": 64, "n": 64}
    assert spec.validate(spec.config(chunk=128), ext).get("chunk") == 128
    with pytest.raises(ValueError, match="at most 128"):
        spec.validate(spec.config(chunk=129), {"t": 1024, "hd": 64,
                                               "n": 64})
    with pytest.raises(ValueError, match="shared memory"):
        spec.validate(spec.config(chunk=64), {"t": 512, "hd": 64,
                                              "n": 512})
    # every candidate the autotuner searches at zamba2-7b's widths is legal
    assert [c.get("chunk") for c in spec.configs(
        ext, preserve_numerics=False)][1:] == [8, 16, 32, 64, 128]
    assert max(tiles.ssd_smem_bytes(64, c) for c in (8, 16, 32, 64, 128)) \
        <= build.SMEM_LIMIT


@pytest.mark.parametrize("t", [sc.DECODE_T_MAX, sc.DECODE_T_MAX + 1])
def test_ssd_decode_boundary_is_unchanged(t):
    plan = sc.plan_ssd(1, t, 112, 64, 64, 4, (ALIGNED,) * 2)
    if t == sc.DECODE_T_MAX:
        assert (plan.variant, plan.lanes, plan.rows, plan.blocks,
                plan.smem) == (sc.DECODE_VECTOR, 8, 16, 448,
                               4 * t * (1 + 2 * 64 + 16))
        assert plan.workspace == 0
    else:
        assert plan.variant == sc.CHUNKED and plan.chunk == t
