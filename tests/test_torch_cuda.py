"""The port's CUDA kernels and executor on the card.

Marked `cuda`: each test skips (from inside the test) where CUDA is not
available.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

builds the kernels from `src/repro_torch/csrc` and holds them against
their plain PyTorch versions, and small split runs on two CUDA streams
(a conv/linear network; a decoder graph with head, kv-block and
ssm-state splits) against the same runs on the CPU; the reduced models
(the transformer; Zamba2, whose Mamba2 layers launch the SSD kernel)
against the same weights on the CPU; the SSD kernels' gradient
(`ScanWithGrad`) against autograd through their plain version; every
candidate of the autotuner's launch table, and a tuned compile measured
on the card.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]

# kernel vs plain, relative to the largest |plain| value: fp32 sums in
# another order (~sqrt(K) * 2^-24); bf16 outputs one 2^-8 rounding apart
RTOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= RTOL[dtype] * max(1.0, float(want.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,c0,width", [
    (1, 4096, 1000, 0, 1000), (1, 300, 77, 13, 50), (9, 64, 130, 2, 128),
    (70, 515, 300, 44, 256),
    (1, 25088, 3368, 0, 3368),        # n18's slow side: 20 splits of K
    (1, 25088, 4096, 728, 3368),      # ... on the full W
    (4, 100, 301, 96, 128),           # ragged N: scalar loads
    (8, 515, 300, 3, 257),            # odd c0, eight rows of X
    (3, 768, 3072, 2480, 592),        # the ViT example split, M <= 8
    (1, 40, 4096, 0, 4096),           # K below a block's floor: 1 split
    (512, 2048, 4096, 0, 4096),       # rwkv6-1.6b prefill plan, M = 512:
    (512, 2048, 4096, 280, 3816),     # the tiled product, in_proj whole
    (512, 4096, 2048, 0, 280),        # and its fast/slow channel panels
    (512, 2048, 4096, 3, 1000),       # odd c0: the narrow-copy variant
    (9, 768, 3072, 2480, 592), (17, 100, 301, 96, 128),
    (64, 3584, 3584, 0, 3584)])       # short M on the tensor cores
def test_split_matmul_kernel_matches_plain(cuda, m, k, n, c0, width, dtype):
    from repro_torch.kernels.split_matmul import (split_matmul,
                                                  split_matmul_plain)
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda) / k ** 0.5).to(dtype)
    before = split_matmul.launches
    got = split_matmul(x, w, c0, width)
    assert split_matmul.launches == before + 1
    assert got.shape == (m, width) and got.dtype == dtype
    _close(got, split_matmul_plain(x, w, c0, width), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_matmul_on_packed_panels_and_odd_pointers(cuda, dtype):
    from repro_torch.core.coexec import SplitPlan, pack_weights
    from repro_torch.kernels.split_matmul import (split_matmul,
                                                  split_matmul_plain)
    from repro_torch.kernels.split_matmul.split_matmul import (SCALAR,
                                                               VECTOR,
                                                               plan_call)
    g = torch.Generator(device=cuda).manual_seed(5)
    k, c_out = 3584, 5696
    x = torch.randn((1, k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((k, c_out), generator=g, device=cuda) / k ** 0.5
         ).to(dtype)
    split = SplitPlan(c_out=c_out, c_fast=1472)
    packed = pack_weights(w, split)
    for side in range(2):                 # packed_w[1] starts K * c_pad in
        panel = packed[side]
        assert plan_call(x, panel, 0, split.width(side)).variant == VECTOR
        _close(split_matmul(x, panel, 0, split.width(side)),
               split_matmul_plain(x, panel, 0, split.width(side)), dtype)
    # a contiguous W one element into its storage: scalar loads
    flat = torch.randn(k * 1000 + 1, generator=g, device=cuda).to(dtype)
    odd = flat[1:].view(k, 1000)
    assert plan_call(x, odd, 0, 1000).variant == SCALAR
    _close(split_matmul(x, odd, 0, 1000), split_matmul_plain(x, odd, 0, 1000),
           dtype)


@pytest.mark.parametrize("m,k,n,c0,width", [(1, 25088, 3368, 0, 728),
                                            (1, 14336, 2296, 0, 1288),
                                            (5, 1000, 301, 7, 200),
                                            (512, 4096, 1768, 0, 280),
                                            (512, 2048, 3816, 0, 3816),
                                            (512, 2048, 4096, 3, 1000)])
def test_split_matmul_is_bit_identical_from_call_to_call(cuda, m, k, n, c0,
                                                         width):
    from repro_torch.kernels.split_matmul import split_matmul
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda) / k ** 0.5
    first = split_matmul(x, w, c0, width)
    for _ in range(3):
        assert torch.equal(split_matmul(x, w, c0, width), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c0", [0, 3])
def test_tiled_product_split_and_unsplit_at_m512(cuda, dtype, c0):
    """rwkv6-1.6b's 280-wide K = 4096 panel at M = 512, with one split, the
    planner's and 16, by 16-byte copies and (c0 = 3) the narrow ones:
    each within RTOL of the plain version, and two calls bit-identical."""
    from repro_torch.kernels.split_matmul import (split_matmul,
                                                  split_matmul_plain)
    from repro_torch.kernels.split_matmul.split_matmul import (
        TILED, TILED_NARROW, plan_call)
    g = torch.Generator(device=cuda).manual_seed(4096 + c0)
    x = torch.randn((512, 4096), generator=g, device=cuda).to(dtype)
    w = (torch.randn((4096, 1768), generator=g, device=cuda) / 64).to(dtype)
    want = split_matmul_plain(x, w, c0, 280)
    assert plan_call(x, w, c0, 280).variant == (TILED if c0 == 0
                                                else TILED_NARROW)
    for launch in (None, {"splits": 1}, {"splits": 16}):
        got = split_matmul(x, w, c0, 280, launch=launch)
        _close(got, want, dtype)
        assert torch.equal(split_matmul(x, w, c0, 280, launch=launch), got)


def test_a_tiled_call_in_a_graph_capture_needs_an_eager_one_first(cuda,
                                                                 monkeypatch):
    """The tiled product's occupancy query and shared-memory attributes are
    runtime calls, made once per dtype and device: a first call inside a
    CUDA graph capture raises; after an eager call a captured one replays
    to the eager result."""
    import importlib

    from repro_torch.kernels.split_matmul import split_matmul
    sm_mod = importlib.import_module(
        "repro_torch.kernels.split_matmul.split_matmul")
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((64, 256), generator=g, device=cuda)
    w = torch.randn((256, 200), generator=g, device=cuda)
    monkeypatch.setattr(sm_mod, "_TILED_RESIDENT", {})
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="graph capture"):
        with torch.cuda.graph(graph, stream=side):
            split_matmul(x, w, 0, 200)
    eager = split_matmul(x, w, 0, 200)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = split_matmul(x, w, 0, 200)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,k,n", [
    (3136, 64, 128), (37, 40, 136), (1, 32, 200),
    (3136, 128, 128), (784, 128, 192), (784, 128, 64),   # VGG16's n4, n6
    (784, 256, 256),                                     # n7, n8
    (50, 33, 70)])                      # K and N unaligned: scalar staging
def test_hadamard_matmul_kernel_matches_plain(cuda, p, k, n, dtype):
    from repro_torch.kernels.winograd_conv import (hadamard_matmul,
                                                   hadamard_matmul_plain)
    g = torch.Generator(device=cuda).manual_seed(p + k + n)
    u = torch.randn((16, p, k), generator=g, device=cuda).to(dtype)
    v = (torch.randn((16, k, n), generator=g, device=cuda) / k ** 0.5
         ).to(dtype)
    before = hadamard_matmul.launches
    got = hadamard_matmul(u, v)
    assert hadamard_matmul.launches == before + 1
    _close(got, hadamard_matmul_plain(u, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,k,n", [(784, 256, 256), (37, 40, 136)])
def test_every_hadamard_tile_matches_plain(cuda, p, k, n, dtype):
    """Each tile the planner may choose, launched directly, on a main-path
    shape and a ragged one."""
    import importlib
    wc = importlib.import_module(
        "repro_torch.kernels.winograd_conv.winograd_conv")
    g = torch.Generator(device=cuda).manual_seed(p + n)
    u = torch.randn((16, p, k), generator=g, device=cuda).to(dtype)
    v = (torch.randn((16, k, n), generator=g, device=cuda) / k ** 0.5
         ).to(dtype)
    code = 0 if dtype == torch.float32 else 1
    for bm, bn in wc.TILES:
        out = torch.empty((16, p, n), dtype=dtype, device=cuda)
        err = wc._launcher()(cuda.index or 0, code, u.data_ptr(),
                             v.data_ptr(), out.data_ptr(), 16, p, k, n, bm,
                             bn, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        _close(out, wc.hadamard_matmul_plain(u, v), dtype)


def test_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.split_matmul import split_matmul
    x = torch.zeros((2, 8), device=cuda)
    with pytest.raises(TypeError):
        split_matmul(x.half(), torch.zeros((8, 8), device=cuda).half(), 0, 8)
    with pytest.raises(ValueError):
        split_matmul(x, torch.zeros((8, 16), device=cuda)[:, ::2], 0, 8)
    with pytest.raises(ValueError):
        split_matmul(x, torch.zeros((8, 8)), 0, 8)


def _small_split_plan():
    """A unit-chain plan over a small network with ragged splits on three
    consecutive convs (n0 -> n1 -> n2 chain through x_plan) and on both
    linears (n4 -> n5 chain); built here from the port's own codecs, so the
    test needs no JAX."""
    from repro_torch.core.types import ConvOp, LinearOp
    from repro_torch.graph.ir import from_units
    from repro_torch.kernels.registry import op_to_json
    from repro_torch.runtime.plan import CoexecPlan, PlanProvenance
    units = [("conv", ConvOp(32, 32, 3, 32, 3, 1)),
             ("conv", ConvOp(32, 32, 32, 128, 3, 1)),
             ("conv", ConvOp(32, 32, 128, 128, 3, 1)),
             ("pool", 4 * 16 * 16 * 128),
             ("linear", LinearOp(1, 16 * 16 * 128, 200)),
             ("linear", LinearOp(1, 200, 10))]
    fast = {0: 8, 1: 16, 2: 40, 4: 72, 5: 3}
    schedule = []
    for i, (kind, op) in enumerate(units):
        if kind == "pool":
            schedule.append({"unit": "pool", "bytes": op})
            continue
        schedule.append({"unit": kind, "decision": {
            "op": op_to_json(op), "c_cpu": op.C_out - fast[i],
            "c_gpu": fast[i], "pred_cpu_us": 1.0, "pred_gpu_us": 1.0,
            "pred_total_us": 1.0}})
    prov = PlanProvenance(device="moto2022", threads=3, mechanism="svm_poll",
                          step=8, seed=1,
                          network_fingerprint=from_units(units).fingerprint(),
                          predictor_checksum="test")
    return CoexecPlan(provenance=prov, schedule=schedule)


def test_split_run_on_two_streams_matches_the_cpu_run(cuda):
    from repro_torch.kernels.split_matmul import split_matmul
    from repro_torch.kernels.winograd_conv import hadamard_matmul
    from repro_torch.runtime.executor import PlanExecutor
    plan = _small_split_plan()
    y_cpu, rep_cpu = PlanExecutor(plan, device="cpu").run()
    exe = PlanExecutor(plan)
    assert exe.device.type == "cuda" and len(exe.groups) == 2
    assert all(g.stream is not None for g in exe.groups)
    for _ in range(3):
        before = (split_matmul.launches, hadamard_matmul.launches)
        y, report = exe.run()
        # both linears split (2 launches each); n1, n2 Winograd on 2 sides
        assert (split_matmul.launches - before[0],
                hadamard_matmul.launches - before[1]) == (4, 4)
        assert (report.elided, report.reshard_points) == \
            (rep_cpu.elided, rep_cpu.reshard_points) == (3, 2)
        np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y.cpu().numpy(),
                                   exe.run_oracle().cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ decode kernels
def _odd(shape, g, cuda, dtype):
    """A contiguous tensor one element into its storage: not 16-byte
    aligned, so the kernels take their scalar-copy instantiations."""
    n = int(np.prod(shape))
    return torch.randn(n + 1, generator=g, device=cuda).to(dtype)[1:].view(
        shape)


@pytest.mark.parametrize("odd", [False, True], ids=["vector", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd,s,pos,window", [
    (32, 32, 112, 3072, 3071, 0),     # zamba2-7b b8.attn, fast side
    (32, 32, 112, 1024, 1023, 0),     # and slow side
    (9, 9, 128, 128, 127, 0),         # deepseek-v2-lite b*.attn, 9 heads
    (7, 7, 128, 128, 127, 0),         # and the other 7 (a head split)
    (32, 8, 128, 4096, 4095, 0),      # GQA g = 4
    (32, 8, 128, 8192, 5000, 1024),   # window: 1024 of 8192 positions
    (16, 4, 64, 2000, 1500, 256),     # sliding window, pos < S - 1
    (8, 2, 112, 1000, 999, 0),        # ragged S
    (4, 4, 16, 10, 9, 0),             # one run, merged on its own
    (6, 2, 36, 300, 250, 0),          # hd * 2 = 72: bf16 copies scalar
])
def test_decode_attention_kernel_matches_plain(cuda, h, kv, hd, s, pos,
                                               window, dtype, odd):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.decode_attention import (
        SCALAR, plan_call)
    g = torch.Generator(device=cuda).manual_seed(h + kv + s)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((h, hd), (s, kv, hd), (s, kv, hd)))
    if odd:
        k = _odd((s, kv, hd), g, cuda, dtype)
        assert plan_call(q, k, v, pos, window).variant == SCALAR
    before = decode_attention.launches
    out, lse = decode_attention(q, k, v, pos, window=window)
    assert decode_attention.launches == before + 1
    want, want_lse = decode_attention_plain(q, k, v, pos, window=window)
    assert out.shape == (h, hd) and out.dtype == dtype
    _close(out, want, dtype)
    _close(lse, want_lse, torch.float32)   # fp32 sums in both


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd,s,pos,window", [
    (32, 32, 112, 3072, 3071, 0), (32, 32, 112, 1024, 1023, 0),
    (32, 8, 128, 8192, 5000, 1024)])
def test_decode_attention_is_bit_identical_from_call_to_call(
        cuda, h, kv, hd, s, pos, window, dtype):
    from repro_torch.kernels.decode_attention import decode_attention
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((h, hd), (s, kv, hd), (s, kv, hd)))
    out, lse = decode_attention(q, k, v, pos, window=window)
    for _ in range(3):
        again, again_lse = decode_attention(q, k, v, pos, window=window)
        assert torch.equal(again, out) and torch.equal(again_lse, lse)


@pytest.mark.parametrize("odd", [False, True], ids=["vector", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd,n", [
    (1, 1, 112, 64, 64),              # zamba2-7b decode step
    (1, 16, 112, 64, 64),             # DECODE_T_MAX: the decode kernel
    (1, 17, 112, 64, 64),             # one more: the chunk kernels
    (1, 64, 8, 64, 64),               # chunk boundaries: one whole chunk,
    (1, 65, 8, 64, 64),               # one more token, two chunks,
    (1, 128, 8, 64, 64),              # two and a token
    (1, 129, 8, 64, 64),
    (1, 300, 8, 64, 64),              # chunked, ragged last chunk
    (2, 100, 6, 32, 16),
    (4, 512, 112, 64, 64),            # the zamba2-7b bf16 prefill's call
    (2, 3, 5, 20, 12),                # decode, ragged rows and N
    (1, 1, 64, 64, 16),               # rwkv6-1.6b plans at N = 16: the
    (1, 512, 64, 64, 16),             # decode step, the chunked prefill
    (1, 512, 21, 64, 16),             # and its ssm-state halves
    (1, 512, 43, 64, 16),
])
def test_ssd_chunk_scan_kernel_matches_plain(cuda, b, t, h, hd, n, dtype,
                                             odd):
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan,
                                               ssd_chunk_scan_plain)
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        CHUNKED, DECODE_SCALAR, DECODE_T_MAX, DECODE_VECTOR, plan_call)
    g = torch.Generator(device=cuda).manual_seed(b + t + h)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    ins = [rand(b, t, h, hd), rand(b, t, n) / n ** 0.5,
           rand(b, t, n) / n ** 0.5,
           0.05 + 0.2 * torch.sigmoid(rand(b, t, h)),
           -(0.1 + rand(h).abs()), rand(b, h, hd, n) / n ** 0.5]
    ins = [u.to(dtype) for u in ins]
    if odd:
        ins[5] = _odd((b, h, hd, n), g, cuda, dtype).div_(n ** 0.5)
    variant = plan_call(*ins, torch.empty_like(ins[5])).variant
    assert variant == (CHUNKED if t > DECODE_T_MAX else
                       DECODE_SCALAR if odd or (n * ins[0].element_size())
                       % 16 else DECODE_VECTOR)
    before = ssd_chunk_scan.launches
    sf, y = ssd_chunk_scan(*ins)
    assert ssd_chunk_scan.launches == before + 1
    sf_p, y_p = ssd_chunk_scan_plain(*ins)
    _close(y, y_p, dtype)
    _close(sf, sf_p, dtype)


@pytest.mark.parametrize("b,t,h,hd,n", [
    (2, 1, 8, 64, 64),                # the decode kernel
    (2, 96, 8, 64, 64),               # the chunk kernels, a ragged chunk
    (1, 300, 6, 32, 16)])
def test_ssd_chunk_scan_carries_a_gradient_on_the_card(cuda, b, t, h, hd, n):
    """With operands that require grad the wrapper still launches its
    kernels once (counted) and its backward gives every operand the
    gradient of autograd through the plain version on the same inputs
    (the backward recomputes that version; the loss is linear in both
    outputs, so the incoming gradients do not depend on the kernels'
    rounding): within 1e-6 of each gradient's largest value."""
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan,
                                               ssd_chunk_scan_plain)
    g = torch.Generator(device=cuda).manual_seed(t + n)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    ins = [rand(b, t, h, hd), rand(b, t, n) / n ** 0.5,
           rand(b, t, n) / n ** 0.5,
           0.05 + 0.2 * torch.sigmoid(rand(b, t, h)),
           -(0.1 + rand(h).abs()), rand(b, h, hd, n) / n ** 0.5]
    wy, ws = rand(b, t, h, hd), rand(b, h, hd, n)
    mine = [u.clone().requires_grad_(True) for u in ins]
    before = ssd_chunk_scan.launches
    sf, y = ssd_chunk_scan(*mine)
    assert ssd_chunk_scan.launches == before + 1
    assert y.grad_fn is not None
    (torch.sum(y * wy) + torch.sum(sf * ws)).backward()
    plain = [u.clone().requires_grad_(True) for u in ins]
    sf_p, y_p = ssd_chunk_scan_plain(*plain)
    _close(y, y_p, torch.float32)
    (torch.sum(y_p * wy) + torch.sum(sf_p * ws)).backward()
    for a, b_ in zip(mine, plain):
        err = float((a.grad - b_.grad).abs().max())
        assert err <= 1e-6 * max(1.0, float(b_.grad.abs().max()))
    with torch.no_grad():
        _, y = ssd_chunk_scan(*mine)
    assert y.grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd,n,chunk", [
    (4, 512, 112, 64, 64, None), (1, 4096, 112, 64, 64, None),
    (2, 300, 6, 32, 16, 128), (1, 100, 5, 20, 12, 16)])
def test_ssd_chunk_kernels_are_bit_identical_from_call_to_call(
        cuda, b, t, h, hd, n, chunk, dtype):
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    g = torch.Generator(device=cuda).manual_seed(b + t)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    ins = [u.to(dtype) for u in (
        rand(b, t, h, hd), rand(b, t, n) / n ** 0.5, rand(b, t, n) / n ** 0.5,
        0.05 + 0.2 * torch.sigmoid(rand(b, t, h)), -(0.1 + rand(h).abs()),
        rand(b, h, hd, n) / n ** 0.5)]
    launch = None if chunk is None else {"chunk": chunk}
    sf, y = ssd_chunk_scan(*ins, launch=launch)
    for _ in range(3):
        again_sf, again_y = ssd_chunk_scan(*ins, launch=launch)
        assert torch.equal(again_sf, sf) and torch.equal(again_y, y)


def test_decode_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    q = torch.zeros((4, 16), device=cuda)
    k = torch.zeros((32, 2, 16), device=cuda)
    with pytest.raises(TypeError):
        decode_attention(q.half(), k.half(), k.half(), 31)
    with pytest.raises(ValueError):
        decode_attention(q, k, k.cpu(), 31)
    with pytest.raises(ValueError):
        decode_attention(q, k[::2], k[::2], 15)
    with pytest.raises(ValueError, match="attends to none"):
        decode_attention(q, k, k, 100, window=8)
    ins = [torch.zeros(s, device=cuda) for s in
           ((1, 64, 2, 256), (1, 64, 256), (1, 64, 256), (1, 64, 2), (2,),
            (1, 2, 256, 256))]
    with pytest.raises(ValueError, match="shared memory"):
        ssd_chunk_scan(*ins)


def test_decode_kernels_refuse_a_strided_operand_by_name(cuda):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    q = torch.zeros((4, 16), device=cuda)
    k = torch.zeros((32, 2, 16), device=cuda)
    v_wide = torch.zeros((32, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="decode_attention: operand v "):
        decode_attention(q, k, v_wide[..., ::2], 31)
    ins = [torch.zeros(s, device=cuda) for s in
           ((1, 1, 2, 16), (1, 1, 8), (1, 1, 8), (1, 1, 2), (2,),
            (1, 2, 16, 8))]
    ins[5] = torch.zeros((1, 2, 16, 16), device=cuda)[..., :8]
    with pytest.raises(ValueError, match="ssd_chunk_scan: operand state0 "):
        ssd_chunk_scan(*ins)


def _small_decode_plan(attn_axis, attn_fast):
    """A decoder graph with one attention and one Mamba2 block, channel
    splits around the typed ones so that they chain in and out, built from
    the port's own codecs (no JAX)."""
    from repro_torch.core.types import AttnOp, LinearOp, SSMOp
    from repro_torch.graph.ir import Graph
    from repro_torch.kernels.registry import op_to_json
    from repro_torch.runtime.plan import CoexecPlan, PlanProvenance
    nodes = [("e", LinearOp(1, 64, 64), (), 0, "channel"),
             ("q", LinearOp(1, 64, 128), ("e",), 40, "channel"),
             ("a", AttnOp(H=8, S=512, KV=4, hd=16), ("q",), attn_fast,
              attn_axis),
             ("o", LinearOp(1, 128, 64), ("a",), 24, "channel"),
             ("r", None, ("e", "o"), 0, ""),
             ("i", LinearOp(1, 64, 128), ("r",), 64, "channel"),
             ("s", SSMOp(T=1, H=8, hd=16, N=16), ("i",), 3, "ssm-state"),
             ("u", LinearOp(1, 128, 64), ("s",), 16, "channel"),
             ("r2", None, ("r", "u"), 0, "")]
    kind = {LinearOp: "linear", AttnOp: "attention", SSMOp: "ssm"}
    size = {"channel": lambda op: op.C_out, "head": lambda op: op.H,
            "kv-block": lambda op: op.S, "ssm-state": lambda op: op.H}
    graph, schedule = [], []
    for nid, op, inputs, fast, axis in nodes:
        if op is None:
            graph.append({"id": nid, "kind": "add", "inputs": list(inputs)})
            schedule.append({"id": nid, "unit": "add"})
            continue
        graph.append({"id": nid, "kind": kind[type(op)],
                      "op": op_to_json(op), "inputs": list(inputs)})
        dec = {"op": op_to_json(op), "c_cpu": size[axis](op) - fast,
               "c_gpu": fast, "pred_cpu_us": 1.0, "pred_gpu_us": 1.0,
               "pred_total_us": 1.0}
        if axis != "channel":
            dec["axis"] = axis
        schedule.append({"id": nid, "unit": kind[type(op)], "decision": dec})
    graph_json = {"schema_version": 2, "nodes": graph}
    prov = PlanProvenance(
        device="moto2022", threads=3, mechanism="svm_poll", step=8, seed=1,
        network_fingerprint=Graph.from_json(graph_json).fingerprint(),
        predictor_checksum="test")
    return CoexecPlan(provenance=prov, schedule=schedule,
                      graph_json=graph_json)


@pytest.mark.parametrize("attn_axis,attn_fast", [("head", 4),
                                                 ("kv-block", 256)])
def test_typed_splits_on_two_streams_match_the_cpu_run(cuda, attn_axis,
                                                       attn_fast):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.split_matmul import split_matmul
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.runtime.executor import PlanExecutor
    plan = _small_decode_plan(attn_axis, attn_fast)
    y_cpu, rep_cpu = PlanExecutor(plan, device="cpu").run()
    exe = PlanExecutor(plan)
    kernels = (split_matmul, decode_attention, ssd_chunk_scan)
    for _ in range(3):
        before = [k.launches for k in kernels]
        y, report = exe.run()
        # e exclusive + 4 channel splits; attention and ssm on both sides
        assert [k.launches - b for k, b in zip(kernels, before)] == [9, 2, 2]
        assert (report.elided, report.reshard_points) == \
            (rep_cpu.elided, rep_cpu.reshard_points)
        np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y.cpu().numpy(),
                                   exe.run_oracle().cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


def _small_conv_plan():
    """A unit chain of two chained Winograd convs, a pool, a direct
    stride-2 conv, a global pool and a linear, every conv and the linear
    channel-split, built from the port's own codecs (no JAX)."""
    from repro_torch.core.types import ConvOp, LinearOp
    from repro_torch.graph.ir import from_units
    from repro_torch.kernels.registry import op_to_json
    from repro_torch.runtime.plan import CoexecPlan, PlanProvenance
    units = [("conv", ConvOp(32, 32, 32, 128, 3, 1), 48),
             ("conv", ConvOp(32, 32, 128, 128, 3, 1), 64),
             ("pool", 4 * 16 * 16 * 128, None),
             ("conv", ConvOp(16, 16, 128, 64, 3, 2), 24),
             ("pool", 4 * 64, None),
             ("linear", LinearOp(1, 64, 10), 4)]
    schedule = []
    for kind, payload, fast in units:
        if kind == "pool":
            schedule.append({"unit": "pool", "bytes": payload})
            continue
        schedule.append({"unit": kind, "decision": {
            "op": op_to_json(payload), "c_cpu": payload.C_out - fast,
            "c_gpu": fast, "pred_cpu_us": 1.0, "pred_gpu_us": 1.0,
            "pred_total_us": 1.0}})
    graph = from_units([(kind, payload) for kind, payload, _ in units])
    prov = PlanProvenance(
        device="moto2022", threads=3, mechanism="svm_poll", step=8, seed=1,
        network_fingerprint=graph.fingerprint(), predictor_checksum="test")
    return CoexecPlan(provenance=prov, schedule=schedule)


@pytest.mark.parametrize("which", ["conv", "decode"])
def test_fused_walk_replays_cuda_graphs(cuda, which):
    """The captured walk on two streams: bit-identical to the per-node
    walk, one graph per fused segment, launch counters credited at every
    replay, a request's output not overwritten by the next request's, and
    `load_params` capturing again."""
    from repro_torch.graph.ir import SEGMENT_FUSED
    from repro_torch.runtime.executor import PlanExecutor
    from repro_torch.runtime.segments import launch_counters
    plan = (_small_conv_plan() if which == "conv"
            else _small_decode_plan("kv-block", 256))
    exe = PlanExecutor(plan)
    x0 = exe.input_template()
    x1 = torch.randn(x0.shape, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    y_node0, rep_node = exe.run(x0, warmup=True)
    y0, rep = exe.run(x0, fused=True, warmup=True)       # captures
    programs = exe.segment_programs()
    assert [p.graph is not None for p in programs] == \
        [p.kind == SEGMENT_FUSED for p in programs]
    assert any(p.launches for p in programs)
    assert torch.equal(y0, y_node0)
    assert rep.sync_points == len(programs) < rep_node.sync_points
    # each channel split's output is gathered once unless it chains inside
    # its segment; typed splits gather or merge inside their own lowering
    coexec = plan.coexec_node_ids()
    assert (rep.reshard_points, rep.elided) == \
        (len(plan.graph_ir().materialization_points(coexec)),
         len(plan.graph_ir().elided(coexec)))

    counters = launch_counters()
    for _ in range(2):
        before = {k: c.launches for k, c in counters.items()}
        y_node1, _ = exe.run(x1)
        mid = {k: c.launches for k, c in counters.items()}
        y1, _ = exe.run(x1, fused=True)
        after = {k: c.launches for k, c in counters.items()}
        assert {k: after[k] - mid[k] for k in after} == \
            {k: mid[k] - before[k] for k in mid}
        assert torch.equal(y1, y_node1)
    assert torch.equal(y0, y_node0)          # not overwritten by request 1
    assert not torch.equal(y0, y1)

    fresh = PlanExecutor(plan, seed=5)
    exe.load_params([None if p is None else p.cpu().numpy()
                     for p in fresh.params])
    y2, _ = exe.run(x0, fused=True)
    assert exe.segment_programs() is not programs
    assert torch.equal(y2, fresh.run(x0)[0])
    assert not torch.equal(y2, y0)


def _portfolio_panels():
    """(K, C_out, c_fast) of every channel split in the batch-4 entries of
    the committed zamba2-7b portfolio: the GEMV's M = 4 panels."""
    import repro_torch
    pf = repro_torch.PlanPortfolio.load(
        ROOT / "src/repro_torch/artifacts/zamba2-7b_b9_moto2022_t1"
               ".portfolio.json")
    panels = set()
    for b, compiled in pf.entries.items():
        for d in compiled.decisions:
            if b.batch == 4 and d.axis == "channel" and d.c_cpu and d.c_gpu:
                assert d.op.L == 4
                panels.add((d.op.C_in, d.op.C_out, d.c_gpu))
    return sorted(panels)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_matmul_takes_the_batch4_panels_on_its_gemv(cuda, dtype):
    """A batch-4 bucket folds its rows into the projections: each side of
    every channel split runs the 16-byte GEMV at M = 4 on its panel."""
    from repro_torch.core.coexec import SplitPlan, pack_weights
    from repro_torch.kernels.split_matmul import (split_matmul,
                                                  split_matmul_plain)
    from repro_torch.kernels.split_matmul.split_matmul import (VECTOR,
                                                               plan_call)
    panels = _portfolio_panels()
    assert panels
    g = torch.Generator(device=cuda).manual_seed(4)
    for k, c_out, c_fast in panels:
        x = torch.randn((4, k), generator=g, device=cuda).to(dtype)
        w = (torch.randn((k, c_out), generator=g, device=cuda) / k ** 0.5
             ).to(dtype)
        split = SplitPlan(c_out=c_out, c_fast=c_fast)
        packed = pack_weights(w, split)
        for side in range(2):
            launch = plan_call(x, packed[side], 0, split.width(side))
            assert (launch.variant, launch.mt) == (VECTOR, 4)
            before = split_matmul.launches
            got = split_matmul(x, packed[side], 0, split.width(side))
            assert split_matmul.launches == before + 1
            _close(got, split_matmul_plain(x, packed[side], 0,
                                           split.width(side)), dtype)


def _zamba_width_plan(splits):
    """A two-block decode graph at zamba2-7b's published widths (a Mamba2
    block, then the attention block), batch 4, a 64-position cache,
    compiled by the grid planner with `splits` forced on, built from the
    port's own codecs (no JAX): `splits` maps a node id to the fast side's
    channels, or to (axis, units) for a typed axis."""
    import dataclasses
    import json
    import tempfile

    import repro_torch
    from repro_torch.api import _artifact_checksum
    from repro_torch.configs.zamba2_7b import CONFIG
    from repro_torch.graph.frontends import from_model
    graph = from_model(dataclasses.replace(CONFIG, attn_every=2), blocks=2,
                       cache_len=64, batch=4)
    with tempfile.TemporaryDirectory() as tmp:
        compiled = repro_torch.compile(
            graph, repro_torch.Target(device="moto2022", threads=1),
            mode="grid", cache=tmp)
    doc = json.loads(json.dumps(compiled.to_json()))
    for entry in doc["plan"]["schedule"]:
        share = splits.get(entry.get("id"))
        if share is None:
            continue
        dec = entry["decision"]
        axis, n_fast = share if isinstance(share, tuple) else \
            ("channel", share)
        size = {"channel": "C_out", "head": "H", "ssm-state": "H",
                "kv-block": "S"}[axis]
        dec.pop("axis", None)
        if axis != "channel":
            dec["axis"] = axis
        dec["c_gpu"], dec["c_cpu"] = n_fast, dec["op"][size] - n_fast
    doc["plan"].pop("segments")            # re-derived from the splits
    doc["checksum"] = _artifact_checksum(doc)
    return repro_torch.CompiledNetwork.from_json(doc)


@pytest.mark.parametrize("variant", ["head", "ssm-state"])
def test_typed_split_lowerings_at_zamba_widths_on_batch4(cuda, variant):
    """The head split of the 32-head attention and the ssm-state split of
    the 112-head SSD scan at zamba2-7b's widths, with the batch-4 rows of
    a portfolio bucket around them: on two CUDA streams, per node and
    fused, against the same plan on the CPU and its oracle, with the
    launch, reshard and elision counts `chip_smoke.py` derives."""
    import importlib.util

    from repro_torch.runtime.executor import PlanExecutor
    from repro_torch.runtime.segments import launch_counters
    splits = ({"b1.q_proj": 2536, "b1.attn": ("head", 16),
               "b1.o_proj": 2536} if variant == "head" else
              {"b0.in_proj": 4096, "b0.ssm": ("ssm-state", 64),
               "b0.out_proj": 2048})
    compiled = _zamba_width_plan(splits)
    spec = importlib.util.spec_from_file_location("chip_smoke_cuda",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke.expected_counts(compiled.plan)
    exe = compiled.executor(device=cuda)
    x = exe.input_template()
    cpu = PlanExecutor(compiled.plan, device="cpu")
    y_cpu, rep_cpu = cpu.run(x.cpu())
    # the CPU walks' counts are the reference executor's
    # (tests/test_torch_portfolio.py)
    _, fused_cpu = cpu.run(x.cpu(), fused=True)
    counters = launch_counters()
    for fused in (False, True):
        exe.run(x, fused=fused, warmup=True)
        before = {k: c.launches for k, c in counters.items()}
        y, rep = exe.run(x, fused=fused)
        assert {k: counters[k].launches - before[k] for k in counters} == \
            {k: want[k] for k in counters}
        # the fused walk gathers the typed splits in their singletons
        assert (rep.reshard_points, rep.elided) == (
            smoke.fused_reshard_counts(compiled.plan) if fused else
            (want["reshard"], want["elided"]))
        on_cpu = fused_cpu if fused else rep_cpu
        assert (rep.reshard_points, rep.elided) == \
            (on_cpu.reshard_points, on_cpu.elided)
        assert tuple(y.shape) == (4, 3584)
        np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y.cpu().numpy(),
                                   exe.run_oracle(x).cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ serving
def _reduced_codeqwen(dtype="float32"):
    import dataclasses

    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("codeqwen15_7b").reduced(),
                              dtype=dtype)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_transformer_on_the_card_matches_the_cpu(cuda, dtype):
    """Prefill (left-padded) and decode steps at a shared and at per-row
    positions: the same weights' logits on the card and on the CPU, whose
    path tests/test_torch_models.py ties to the reference's; fp32 within
    1e-4 of the largest |logit|, bf16 within the reference's 5e-2."""
    cfg, model, params = _reduced_codeqwen(dtype)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, 9)))
    start = torch.tensor([0, 2, 5])
    out = {}
    for dev, p in (("cpu", params), ("cuda", _on(params, cuda))):
        cache = model.init_cache(3, 24, device=dev)
        logits, cache = model.prefill(p, toks.to(dev), cache,
                                      start=start.to(dev))
        out[dev] = [logits]
        for i in range(3):
            pos = 9 + i if i < 2 else torch.tensor([11, 13, 12], device=dev)
            logits, cache = model.decode_step(p, toks[:, i:i + 1].to(dev),
                                              cache, pos,
                                              start=start.to(dev))
            out[dev].append(logits)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for want, got in zip(out["cpu"], out["cuda"]):
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())


def test_scheduler_on_the_card_matches_solo_runs(cuda):
    """Continuous batching on the card (fp32, TF32 off): each greedy
    completion equals the request served alone by the fixed-batch
    engine, and sampled rows draw from a CUDA generator."""
    from repro_torch.serving import (ContinuousScheduler, SchedulerConfig,
                                     ServingEngine, poisson_requests)
    cfg, model, params = _reduced_codeqwen()
    params = _on(params, cuda)
    reqs = poisson_requests(10, rate=500.0, vocab_size=cfg.vocab_size,
                            temperatures=(0.0,), seed=4)
    rep = ContinuousScheduler(cfg, model, params, device=cuda,
                              config=SchedulerConfig(max_batch=3,
                                                     max_len=40)).run(reqs)
    got = {c.rid: c.tokens for c in rep.completions}
    for r in reqs:
        solo = ServingEngine(cfg, model, params, max_batch=1, max_len=40,
                             device=cuda).run([r])[0].tokens
        assert got[r.rid] == solo
    hot = poisson_requests(6, rate=500.0, vocab_size=cfg.vocab_size,
                           temperatures=(0.7,), seed=5)
    rep = ContinuousScheduler(cfg, model, params, device=cuda,
                              config=SchedulerConfig(max_batch=3,
                                                     max_len=40)).run(hot)
    assert rep.total_tokens == sum(r.max_new_tokens for r in hot)


def test_engine_executes_a_codeqwen_plan_on_the_card(cuda, tmp_path):
    """A reduced codeqwen portfolio entry shipped with the engine: its
    plan runs on two CUDA streams through the kernels, within 1e-4 of its
    oracle, its records appended to the store."""
    import repro_torch
    from repro_torch.runtime.segments import launch_counters
    from repro_torch.serving import ServingEngine
    cfg, model, params = _reduced_codeqwen()
    pf = repro_torch.compile_portfolio(
        cfg, repro_torch.Target(device="moto2022"), buckets=((4, 64),),
        cache=tmp_path / "plans", samples=120, estimators=25)
    compiled = pf.entries[pf.buckets[0]]
    engine = ServingEngine(cfg, model, _on(params, cuda), compiled=compiled,
                           measurement_store=tmp_path / "meas", device=cuda)
    engine.execute_plan()                      # kernel builds
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    y, report = engine.execute_plan()
    assert counters["split_matmul"].launches > before["split_matmul"]
    assert counters["decode_attention"].launches > \
        before["decode_attention"]
    x = engine.plan_executor.input_template()
    np.testing.assert_allclose(
        y.cpu().numpy(), engine.plan_executor.run_oracle(x).cpu().numpy(),
        rtol=1e-4, atol=1e-4)
    assert engine.drift is not None



# ------------------------------------------------------------------- zamba
def _zamba_mixer(dtype, seed=0):
    """Reduced zamba2-7b's Mamba2 params on the CPU, A_log and dt_bias
    drawn off their zero init so every term of the recurrence counts."""
    import dataclasses

    from repro_torch.models import get_config
    from repro_torch.models.ssm import init_mamba2
    cfg = dataclasses.replace(get_config("zamba2_7b").reduced(), dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    p = init_mamba2(gen, cfg, getattr(torch, dtype))
    h = p["A_log"].shape[0]
    p["A_log"] = 0.5 * torch.randn(h, generator=gen)
    p["dt_bias"] = 0.5 * torch.randn(h, generator=gen)
    return cfg, p, gen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 40, 300])
def test_mamba2_mix_launches_the_ssd_kernel_and_matches_the_cpu(cuda, dtype,
                                                                 t):
    """One `ssd_chunk_scan` launch per call (the decode kernel at T = 1,
    the chunk kernels above 16 tokens), and y, the final state and the
    conv carry within 1e-4 (fp32) or 5e-2 (bf16) of the same call on the
    CPU, which tests/test_torch_zamba.py ties to the reference's."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.models.ssm import mamba2_mix, mamba2_state_shapes
    cfg, p, gen = _zamba_mixer(dtype, seed=t)
    s_shape, c_shape = mamba2_state_shapes(cfg, 2)
    x = torch.randn((2, t, cfg.d_model), generator=gen).to(p["w_in"].dtype)
    state = 0.5 * torch.randn(s_shape, generator=gen)
    carry = torch.randn(c_shape, generator=gen).to(x.dtype)
    want = mamba2_mix(p, x, cfg, state, carry)
    before = ssd_chunk_scan.launches
    got = mamba2_mix(_on(p, cuda), x.to(cuda), cfg, state.to(cuda),
                     carry.to(cuda))
    assert ssd_chunk_scan.launches == before + 1
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        err = float((g.cpu().float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_zamba_on_the_card_matches_the_cpu(cuda, dtype):
    """Prefill (T = 40: the chunk kernels) and three decode steps (the
    decode kernel) of reduced zamba2-7b with 4 layers: one SSD launch per
    Mamba2 layer each, and the logits within 1e-4 (fp32) or 5e-2 (bf16)
    of the same weights' on the CPU."""
    import dataclasses

    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("zamba2_7b").reduced(n_layers=4),
                              dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (3, 43)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", _on(params, cuda))):
        cache = model.init_cache(3, 48, device=dev)
        before = ssd_chunk_scan.launches
        logits, cache = model.prefill(p, toks[:, :40].to(dev), cache)
        out[dev] = [logits]
        for i in range(3):
            logits, cache = model.decode_step(
                p, toks[:, 40 + i:41 + i].to(dev), cache, 40 + i)
            out[dev].append(logits)
        launched = ssd_chunk_scan.launches - before
        assert launched == (4 * cfg.n_layers if dev == "cuda" else 0)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for want, got in zip(out["cpu"], out["cuda"]):
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())


# ------------------------------------------------------------- autotune

#: one op per kind with a launch grid, at small shapes
TUNE_OPS = {
    "gemv": ("linear", dict(L=4, C_in=3000, C_out=520)),
    "tiled": ("linear", dict(L=70, C_in=300, C_out=200)),
    # rwkv6-1.6b's 280-wide K = 4096 panel: blocks and splits
    "tiled m512": ("linear", dict(L=512, C_in=4096, C_out=280)),
    "conv": ("conv", dict(H_in=40, W_in=40, C_in=40, C_out=136)),
    "attention": ("attention", dict(H=8, S=700, KV=2, hd=64)),
    "ssm": ("ssm", dict(T=200, H=6, hd=32, N=16)),
}


@pytest.mark.parametrize("name", sorted(TUNE_OPS))
def test_every_launch_candidate_matches_the_default_launch(cuda, name):
    """Every candidate of the op's Hopper launch spec, both search modes,
    in fp32: within RTOL of the default launch (itself held against the
    plain version above), and each output-tiling one bit-identical to
    it."""
    from repro_torch.core import types
    from repro_torch.kernels import registry, tiles
    from repro_torch.runtime.autotune import kernel_call
    kind, fields = TUNE_OPS[name]
    op = {"linear": types.LinearOp, "conv": types.ConvOp,
          "attention": types.AttnOp, "ssm": types.SSMOp}[kind](**fields)
    spec = tiles.launch_spec(kind)
    grid = spec.configs(registry.launch_extents(op),
                        preserve_numerics=False)
    assert len(grid) > 1
    call = kernel_call(op, 3)
    default = call(spec.default())
    default = default if isinstance(default, tuple) else (default,)
    for launch in grid:
        got = call(launch)
        got = got if isinstance(got, tuple) else (got,)
        tiling = not any(spec.param(n).reduction for n, _ in launch.values)
        for g, d in zip(got, default):
            if tiling:
                assert torch.equal(g, d), launch.label()
            _close(g, d, torch.float32)


def test_every_launch_candidate_matches_plain_in_bf16(cuda):
    from repro_torch.kernels import tiles
    from repro_torch.kernels.split_matmul import (split_matmul,
                                                  split_matmul_plain)
    from repro_torch.kernels.winograd_conv import (hadamard_matmul,
                                                   hadamard_matmul_plain)
    g = torch.Generator(device=cuda).manual_seed(9)
    u = torch.randn((16, 400, 40), generator=g, device=cuda).bfloat16()
    v = torch.randn((16, 40, 136), generator=g, device=cuda).bfloat16()
    for launch in tiles.launch_spec("conv").configs(
            {"p": 400, "k": 40, "n": 136}):
        _close(hadamard_matmul(u, v, launch=launch),
               hadamard_matmul_plain(u, v), torch.bfloat16)
    x = torch.randn((70, 300), generator=g, device=cuda).bfloat16()
    w = torch.randn((300, 200), generator=g, device=cuda).bfloat16() / 17
    for launch in tiles.launch_spec("linear").configs(
            {"m": 70, "k": 300, "n": 200}):
        _close(split_matmul(x, w, 0, 200, launch=launch),
               split_matmul_plain(x, w, 0, 200), torch.bfloat16)


def test_a_tuned_compile_on_the_card(cuda, tmp_path):
    """`compile(tune=True)` measures on the card: a cold compile times
    each op's candidates, a warm one none; the tuned network runs through
    the kernels with its launches, bit-identical to the untuned one (only
    output-tiling launches are searched)."""
    import repro_torch
    import repro_torch.runtime.autotune as at
    from repro.core.types import ConvOp, LinearOp
    net = [("conv", ConvOp(32, 32, 32, 128, 3, 1)),
           ("conv", ConvOp(32, 32, 128, 128, 3, 1)),
           ("pool", 4 * 128), ("linear", LinearOp(1, 128, 64))]
    from test_torch_support import to_port
    net = [(k, to_port(p) if k != "pool" else p) for k, p in net]
    target = repro_torch.Target(device="moto2022", threads=3)
    kw = dict(cache=tmp_path / "plans", samples=60, estimators=8)
    assert at.measure_device() == (torch.cuda.get_device_name(), "cuda")
    assert at.measure_tile_us(to_port(ConvOp(32, 32, 32, 128))) > 0
    tuned = repro_torch.compile(net, target, tune=True,
                                tune_cache=tmp_path / "tune", **kw)
    assert sum(len(e["measured_us"]) for e in tuned.tuned) >= 4
    real = at.measure_tile_us
    at.measure_tile_us = lambda *a, **k: pytest.fail("measured warm")
    try:
        warm = repro_torch.compile(net, target, tune=True,
                                   tune_cache=tmp_path / "tune", **kw)
    finally:
        at.measure_tile_us = real
    assert warm.from_cache and warm.launches == tuned.launches
    base = repro_torch.compile(net, target, **kw)
    x = base.executor(device=cuda).input_template()
    y = tuned.run(x, device=cuda)
    assert torch.equal(y, base.run(x, device=cuda))
    assert torch.equal(tuned.run(x, device=cuda, fused=True), y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_rwkv_on_the_card_matches_the_cpu(cuda, dtype):
    """Prefill (T = 64: the chunked WKV) and three decode steps (the step
    recurrence) of reduced rwkv6-1.6b: no launch of the port's kernels
    (the WKV is plain PyTorch, as the reference's), and the logits within
    1e-4 (fp32) or 5e-2 (bf16) of the same weights' on the CPU, which
    tests/test_torch_rwkv.py ties to the reference's."""
    import dataclasses

    from repro_torch.models import build_model, get_config
    from repro_torch.runtime.segments import launch_counters
    cfg = dataclasses.replace(get_config("rwkv6_1b6").reduced(),
                              dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, (3, 67)))
    counters = launch_counters()
    out = {}
    for dev, p in (("cpu", params), ("cuda", _on(params, cuda))):
        cache = model.init_cache(3, device=dev)
        before = {k: fn.launches for k, fn in counters.items()}
        logits, cache = model.prefill(p, toks[:, :64].to(dev), cache)
        got = [logits]
        for i in range(3):
            logits, cache = model.decode_step(
                p, toks[:, 64 + i:65 + i].to(dev), cache, 64 + i)
            got.append(logits)
        assert {k: fn.launches for k, fn in counters.items()} == before
        out[dev] = torch.stack(got, dim=1).cpu().float()
    tol = 1e-4 if dtype == "float32" else 5e-2
    err = float((out["cuda"] - out["cpu"]).abs().max())
    assert err <= tol * float(out["cpu"].abs().max())
