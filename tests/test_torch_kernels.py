"""The port's kernel modules against the JAX package, on the CPU.

Here the wrappers take their plain PyTorch versions (the tensors lie on
the CPU); the CUDA kernels themselves are held against those plain
versions on the card by `chip_smoke.py` and `test_torch_cuda.py`.  The
JAX side runs its Pallas kernels with `interpret=True`, as the
reference's own tests do, on inputs made from one numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.split_matmul import split_matmul_op as jax_split_matmul_op
from repro.kernels.winograd_conv import conv2d_ref as jax_conv2d_ref
from repro.kernels.winograd_conv import hadamard_matmul as jax_hadamard
from repro.kernels.winograd_conv import winograd_conv2d as jax_winograd
from repro.kernels.winograd_conv.ops import _conv_oracle as jax_conv_oracle
from repro.core.types import ConvOp as JConvOp

from repro_torch.core.types import ConvOp, LinearOp
from repro_torch.kernels import build, registry
from repro_torch.kernels.split_matmul import split_matmul, split_matmul_plain
from repro_torch.kernels.winograd_conv import (conv2d_op, conv2d_ref,
                                               hadamard_matmul,
                                               hadamard_matmul_plain,
                                               winograd_conv2d,
                                               winograd_eligible)
from repro_torch.kernels.winograd_conv.ref import same_pads

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = _DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _legal(v, extent, align):
    return min(v, -(-extent // align) * align)


# ------------------------------------------------------------ split_matmul
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,c0,width", [
    (8, 64, 256, 0, 256),        # full width
    (50, 768, 3072, 2480, 592),  # the paper's ViT running example split
    (17, 100, 301, 96, 128),     # ragged everything
    (128, 512, 1024, 512, 512),  # aligned halves
    (1, 32, 64, 8, 40),          # tiny
])
def test_split_matmul_plain_matches_jax_kernel(m, k, n, c0, width, dtype):
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    jx, tx = _pair(rng, (m, k), dtype)
    jw, tw = _pair(rng, (k, n), dtype)
    want = jax_split_matmul_op(jx, jw, c0, width, bm=_legal(32, m, 8),
                               bn=_legal(128, n, 128),
                               bk=_legal(128, k, 128), interpret=True)
    got = split_matmul(tx, tw, c0, width)
    assert got.shape == (m, width) and got.dtype == tx.dtype
    # fp32: K-accumulation rounding grows ~sqrt(K), and near-zero outputs
    # only have atol to absorb it; bf16: one output rounding step (2^-8)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol * np.sqrt(k))


def test_split_matmul_complementary_widths_cover_the_partition():
    rng = np.random.default_rng(0)
    _, x = _pair(rng, (50, 768), "float32")
    _, w = _pair(rng, (768, 3072), "float32")
    c_fast = 2480
    a = split_matmul(x, w, 0, c_fast)
    b = split_matmul(x, w, c_fast, 3072 - c_fast)
    # the same fp32 products, summed by one matmul or two: order only
    torch.testing.assert_close(torch.cat([a, b], -1), x @ w,
                               rtol=2e-5, atol=2e-5)


def test_split_matmul_on_cpu_runs_the_plain_version_and_never_launches():
    rng = np.random.default_rng(1)
    _, x = _pair(rng, (3, 40), "float32")
    _, w = _pair(rng, (40, 24), "float32")
    before = split_matmul.launches
    got = split_matmul(x, w, 8, 16)
    assert torch.equal(got, split_matmul_plain(x, w, 8, 16))
    linear = registry.get_lowering("linear")
    op = LinearOp(3, 40, 24)
    assert torch.equal(linear.kernel(x, w, op), linear.oracle(x, w, op))
    assert split_matmul.launches == before


@pytest.mark.parametrize("c0,width", [(-1, 4), (0, 0), (20, 8)])
def test_split_matmul_rejects_slices_outside_w(c0, width):
    with pytest.raises(ValueError):
        split_matmul(torch.zeros(2, 4), torch.zeros(4, 24), c0, width)


def test_kernel_operands_must_lie_on_one_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        build.dtype_code("split_matmul", torch.zeros(2, 2), torch.zeros(2, 2))


# --------------------------------------------------------- hadamard_matmul
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,k,n", [(64, 32, 128), (37, 40, 136), (1, 32, 8)])
def test_hadamard_matmul_plain_matches_jax_kernel(p, k, n, dtype):
    rng = np.random.default_rng(p * 131 + k + n)
    ju, tu = _pair(rng, (16, p, k), dtype)
    jv, tv = _pair(rng, (16, k, n), dtype)
    want = jax_hadamard(ju, jv, bm=_legal(32, p, 8), bn=_legal(128, n, 128),
                        bk=_legal(128, k, 128), interpret=True)
    before = hadamard_matmul.launches
    got = hadamard_matmul(tu, tv)
    assert hadamard_matmul.launches == before
    assert got.shape == (16, p, n) and got.dtype == tu.dtype
    assert torch.equal(got, hadamard_matmul_plain(tu, tv))
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol * np.sqrt(k))


# ----------------------------------------------------------- winograd_conv
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (1, 8, 8, 32, 128),
    (2, 16, 16, 64, 160),
    (1, 15, 17, 32, 136),        # odd spatial dims
])
def test_winograd_conv_matches_jax_winograd_and_direct(b, h, w, cin, cout):
    rng = np.random.default_rng(b * 1000 + h * 10 + w)
    jx, tx = _pair(rng, (b, h, w, cin), "float32", 0.3)
    jw, tw = _pair(rng, (3, 3, cin, cout), "float32", 0.3)
    got = winograd_conv2d(tx, tw)
    want_wino = jax_winograd(jx, jw, interpret=True,
                             bm=_legal(32, -(-h // 2) * -(-w // 2), 8),
                             bn=_legal(128, cout, 128),
                             bk=_legal(128, cin, 128))
    want_direct = jax_conv2d_ref(jx, jw)
    assert got.shape == (b, h, w, cout)
    # the same transforms in the same order: fp32 rounding only
    np.testing.assert_allclose(_np(got), _np(want_wino), rtol=1e-5,
                               atol=1e-5)
    # Winograd vs direct: the transforms reassociate every output's sum
    np.testing.assert_allclose(_np(got), _np(want_direct), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(conv2d_ref(tx, tw)), _np(want_direct),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(16, 16), (15, 9), (7, 7)])
@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (3, 2), (7, 2), (7, 1)])
def test_direct_conv_lowering_matches_jax_at_every_stride_and_filter(
        h, w, k, s):
    rng = np.random.default_rng(h * 100 + w * 10 + k + s)
    cin, cout = 8, 12
    jx, tx = _pair(rng, (1, h, w, cin), "float32")
    jw, tw = _pair(rng, (k, k, cin, cout), "float32", 0.2)
    np.testing.assert_allclose(_np(conv2d_ref(tx, tw, stride=s)),
                               _np(jax_conv2d_ref(jx, jw, stride=s)),
                               rtol=1e-5, atol=1e-5)
    # registry lowerings crop SAME's ceil(H/S) rows to the declared floor
    op = ConvOp(h, w, cin, cout, k, s)
    want = jax_conv_oracle(jx, jw, JConvOp(h, w, cin, cout, k, s))
    for fn in (registry.get_lowering("conv").kernel,
               registry.get_lowering("conv").oracle):
        got = fn(tx, tw, op)
        assert tuple(got.shape) == (1, op.H_out, op.W_out, cout)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,s", [(224, 3, 1), (15, 3, 2), (16, 7, 2),
                                   (16, 1, 2), (17, 7, 1)])
def test_same_padding_reproduces_xla_geometry(n, k, s):
    lo, hi = same_pads(n, k, s)
    out = -(-n // s)
    assert (n + lo + hi - k) // s + 1 == out
    assert hi - lo in (0, 1)


def test_winograd_gate_is_decided_on_the_declared_op():
    """VGG16's n6 (56x56x128 -> 256) co-executes 192/64: its 64-channel
    slow side keeps the Winograd path because the gate reads the op."""
    n6 = ConvOp(56, 56, 128, 256, 3, 1)
    assert winograd_eligible(n6)
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((1, 56, 56, 128)), dtype=torch.float32)
    w_slow = torch.tensor(rng.standard_normal((3, 3, 128, 64)) * 0.03,
                          dtype=torch.float32)
    got = conv2d_op(x, w_slow, n6)
    torch.testing.assert_close(got, winograd_conv2d(x, w_slow), rtol=0,
                               atol=0)
    assert winograd_eligible(ConvOp(32, 32, 32, 128, 3, 1))
    for op in (ConvOp(56, 56, 128, 64, 3, 1),      # C_out < 128
               ConvOp(28, 28, 256, 512, 3, 1),     # H*W = 784 < 1024
               ConvOp(224, 224, 3, 64),            # C_in < 32
               ConvOp(32, 32, 16, 512),            # C_in < 32
               ConvOp(56, 56, 128, 256, 3, 2),     # stride 2
               ConvOp(56, 56, 128, 256, 1, 1)):    # 1x1
        assert not winograd_eligible(op)


# ------------------------------------------------------------------ build
def test_build_needs_nvcc_and_names_libraries_by_their_sources(monkeypatch,
                                                               tmp_path):
    import shutil
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "out")
    lib = build.library_path("split_matmul")
    assert lib.parent == tmp_path / "out"
    assert lib.name.startswith("libsplit_matmul-") and lib.suffix == ".so"
    # an edit to a shared header changes every library's name: rebuilt
    header = csrc / "tiled_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path("split_matmul") != lib
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["split_matmul"])
    # a library already built for these sources is loaded as it is
    done = build.library_path("hadamard_matmul")
    done.parent.mkdir(parents=True)
    done.touch()
    assert build.build(["hadamard_matmul"]) == {"hadamard_matmul": ""}
    with pytest.raises(KeyError):
        build.source_digest("no_such_kernel")
