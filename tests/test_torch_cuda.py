"""The port's CUDA kernels and executor on the card.

Marked `cuda`: each test skips (from inside the test) where CUDA is not
available.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

builds the kernels from `src/repro_torch/csrc` and holds them against
their plain PyTorch versions, and the small network's split run on two
CUDA streams against the same run on the CPU.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

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
    (70, 515, 300, 44, 256)])
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
@pytest.mark.parametrize("p,k,n", [(3136, 64, 128), (37, 40, 136),
                                   (1, 32, 200)])
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
