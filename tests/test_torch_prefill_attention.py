"""The causal prefill-attention kernel (`kernels/prefill_attention`) and
the published Zamba2's prefill through it.

On the CPU: the wrapper computes its plain version (`ref.py`), which is
`attention_scores` under a causal mask bit for bit; it refuses what the
kernel does not take; the reduced Zamba2 prefills exactly as it did
before the kernel, launching nothing.  Marked `cuda` (each skips from
inside the test where there is no card; on a card, `PYTHONPATH=src
python -m pytest -q -m cuda tests/test_torch_prefill_attention.py`): the
kernel against its plain version at zamba2-7b's shapes, ragged lengths,
strided operands and a GQA shape, and a full-width zamba2-7b prefill of
4 x 4096 tokens launching it once per hybrid layer.
"""
import dataclasses
import math
import types

import pytest
import torch

from repro_torch.kernels.prefill_attention import (check_operands,
                                                   head_width,
                                                   prefill_attention,
                                                   prefill_attention_ref)
from repro_torch.kernels.prefill_attention.prefill_attention import (
    kernel_strides)
from repro_torch.models import build_model, get_config
from repro_torch.models.layers import _causal_mask, attention_scores

ZAMBA_SCALE = 112 ** -0.5


def _operands(b, t, h, kv, hd, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, t, n, hd), generator=g, device=device)
            .to(dtype) for n in (h, kv, kv)]


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,hd,scale", [
    (2, 21, 4, 4, 32, ZAMBA_SCALE), (1, 50, 8, 2, 64, None),
    (3, 1, 2, 1, 16, 0.3)])
def test_cpu_takes_the_plain_path_bit_for_bit(b, t, h, kv, hd, scale,
                                              dtype):
    q, k, v = _operands(b, t, h, kv, hd, dtype)
    before = prefill_attention.launches
    got = prefill_attention(q, k, v, scale=scale)
    assert prefill_attention.launches == before
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.equal(got, prefill_attention_ref(q, k, v, scale=scale))
    want = attention_scores(q, k, v, _causal_mask(t, t), scale=scale)
    assert torch.equal(got, want)


def test_the_plain_version_is_causal_softmax_attention():
    q, k, v = _operands(2, 9, 4, 2, 16, seed=3)
    got = prefill_attention_ref(q, k, v, scale=0.25)
    for i in range(9):
        kk = k[:, :i + 1].repeat_interleave(2, dim=2)      # (B, i+1, H, hd)
        vv = v[:, :i + 1].repeat_interleave(2, dim=2)
        w = torch.softmax(torch.einsum("bhd,bshd->bhs", q[:, i], kk) * 0.25,
                          dim=-1)
        want = torch.einsum("bhs,bshd->bhd", w, vv)
        assert torch.allclose(got[:, i], want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("case", [
    "float16", "mixed dtypes", "float32 on cuda", "hd 24", "hd 272",
    "hd 8", "keys longer", "kv not dividing h", "v shape", "3-d q",
    "q wider"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, k, v = _operands(2, 8, 4, 2, 32)
    device_type = None
    if case == "float16":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "mixed dtypes":
        k = k.bfloat16()
    elif case == "float32 on cuda":
        device_type = "cuda"
    elif case.startswith("hd "):
        hd = int(case.split()[1])
        q, k, v = _operands(2, 8, 4, 2, hd)
    elif case == "keys longer":
        k, v = (torch.cat([x, x], dim=1) for x in (k, v))
    elif case == "kv not dividing h":
        q, k, v = _operands(2, 8, 4, 3, 32)
    elif case == "v shape":
        v = v[:, :, :1]
    elif case == "3-d q":
        q = q[0]
    elif case == "q wider":
        q = torch.cat([q, q], dim=-1)
    err = TypeError if case in ("float16", "mixed dtypes",
                                "float32 on cuda") else ValueError
    with pytest.raises(err):
        check_operands(q, k, v, device_type)
    if device_type is None:
        with pytest.raises(err):
            prefill_attention(q, k, v)


@pytest.mark.parametrize("hd,width", [(16, 64), (64, 64), (80, 128),
                                      (128, 128), (144, 224), (224, 224),
                                      (240, 256), (256, 256)])
def test_head_widths_pad_to_an_instantiated_width(hd, width):
    assert head_width(hd) == width


def test_a_scale_that_is_not_positive_is_refused():
    q, k, v = _operands(1, 4, 2, 2, 16)
    for scale in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError, match="scale"):
            prefill_attention(q, k, v, scale=scale)


def test_strides_of_a_fused_projection_and_refused_layouts():
    b, t, h, hd = 2, 5, 4, 32
    qkv = torch.zeros((b, t, 3 * h * hd), dtype=torch.bfloat16)
    q, k, v = qkv.reshape(b, t, 3, h, hd).unbind(2)
    assert kernel_strides("v", v) == (t * 3 * h * hd, 3 * h * hd, hd)
    with pytest.raises(ValueError, match="operand k"):
        kernel_strides("k", k.transpose(2, 3))          # last dim strided
    flat = torch.zeros(b * t * h * hd + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="operand q"):  # 2 bytes off
        kernel_strides("q", flat[1:].view(b, t, h, hd))
    odd = torch.zeros((b, t, h, hd + 4), dtype=torch.bfloat16)[..., :hd]
    with pytest.raises(ValueError):                     # 72-byte rows
        kernel_strides("q", odd)


@pytest.mark.parametrize("where", ["init", "init_cache"])
def test_float32_is_refused_on_cuda_before_any_allocation(where):
    """The kernel takes bf16 only, so a float32 Zamba2 is refused on
    CUDA where its weights or its cache would be made, with the reason,
    not with the kernel's TypeError in the middle of a prefill."""
    _, model, _ = _tiny("float32")
    with pytest.raises(ValueError, match="bfloat16 only on CUDA"):
        if where == "init":
            model.init(types.SimpleNamespace(device=torch.device("cuda")))
        else:
            model.init_cache(2, 8, "cuda")
    cache = model.init_cache(2, 8, "cpu")           # the CPU takes it
    assert cache["k"][0].dtype == torch.float32


def test_bfloat16_passes_the_cuda_refusal():
    from repro_torch.models.zamba2_published import _refuse_on_cuda
    _refuse_on_cuda("cuda", torch.bfloat16)
    _refuse_on_cuda(None, torch.bfloat16)
    _refuse_on_cuda("cpu", torch.float32)
    for device in ("cuda", "cuda:1", None, torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="float32"):
            _refuse_on_cuda(device, torch.float32)


def _tiny(dtype):
    cfg = dataclasses.replace(get_config("zamba2-7b-instruct").reduced(),
                              dtype=dtype)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(1))


def _attend_as_before(self, q, k, v, pos):
    """The shared block's attention before the kernel, below the flash
    threshold: `attention_scores` under the causal mask at offset pos."""
    t, s = q.shape[1], k.shape[1]
    return attention_scores(q, k, v, _causal_mask(t, s, q_offset=pos),
                            scale=self.scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_reduced_zamba2_prefills_as_before_on_the_cpu(dtype,
                                                          monkeypatch):
    cfg, model, params = _tiny(dtype)
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(2))
    before = prefill_attention.launches
    got, _ = model.prefill(params, tokens, model.init_cache(2, 40, "cpu"))
    assert prefill_attention.launches == before
    assert model.last_prefill_counts["prefill_attention"] == 0
    assert model.last_prefill_counts["shared_applications"] == cfg.n_hybrid
    monkeypatch.setattr(type(model), "_attend", _attend_as_before)
    want, _ = model.prefill(params, tokens, model.init_cache(2, 40, "cpu"))
    assert torch.equal(got, want)


# ---------------------------------------------------------------- card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _exact(q, k, v, scale):
    """Causal attention in fp32 from the bf16 operands, one batch row at
    a time (the (H, T, T) scores of one row are 2 GB at T = 4096)."""
    return torch.cat([prefill_attention_ref(
        q[i:i + 1].float(), k[i:i + 1].float(), v[i:i + 1].float(),
        scale=scale) for i in range(q.shape[0])])


def _plain(q, k, v, scale):
    return torch.cat([prefill_attention_ref(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], scale=scale)
                      for i in range(q.shape[0])])


def _row_err(got, want) -> float:
    """The largest relative error of one output row (one query and
    head): max over rows of rms(got - want) / rms(want), each row's size
    setting its own scale."""
    diff = (got.float() - want.float()).pow(2).mean(-1)
    return float((diff / want.float().pow(2).mean(-1)).sqrt().max())


def _hold(q, k, v, scale):
    """The kernel against the plain version and both against fp32, row
    by row (`_row_err`): the first query rows copy one value row, the
    deep ones average hundreds and are many times smaller.

    The two round at different points: the plain version rounds the
    scores to bf16 (the score product's output type) and the normalised
    probabilities to bf16; the kernel keeps the scores in fp32 and rounds
    the unnormalised probabilities to bf16, dividing by the fp32 row sum
    at the end.  Each differs from fp32 attention by about one bf16 step
    of each output (2^-8 of a row's rms, where a dropped 64-key tile
    moves a row by a quarter of it or more), so the kernel is held (a)
    within 2^-5 of the plain version, row by row, and (b) no further
    from fp32 than the plain version is, with a quarter of a bf16 step
    (2^-10) of room."""
    before = prefill_attention.launches
    got = prefill_attention(q, k, v, scale=scale)
    assert prefill_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    plain, exact = _plain(q, k, v, scale), _exact(q, k, v, scale)
    err = _row_err(got, plain)
    assert err <= 2 ** -5, err
    ours, theirs = _row_err(got, exact), _row_err(plain, exact)
    assert ours <= theirs + 2 ** -10, (ours, theirs)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1024, 2048, 4096, 77, 1000])
def test_kernel_matches_plain_at_zamba2_shapes(cuda, t):
    q, k, v = _operands(4, t, 32, 32, 224, torch.bfloat16, cuda, seed=t)
    _hold(q, k, v, ZAMBA_SCALE)


@pytest.mark.cuda
def test_kernel_reads_strided_views_of_a_fused_projection(cuda):
    b, t, h, hd = 2, 700, 32, 224
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((b, t, 3 * h * hd), generator=g,
                      device=cuda).bfloat16()
    q, k, v = qkv.reshape(b, t, 3, h, hd).unbind(2)
    got = _hold(q, k, v, ZAMBA_SCALE)
    assert torch.equal(got, prefill_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), scale=ZAMBA_SCALE))


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd,t", [(8, 2, 128, 513), (4, 4, 64, 130),
                                       (4, 1, 16, 70), (2, 2, 256, 300)])
def test_kernel_matches_plain_on_gqa_and_other_widths(cuda, h, kv, hd, t):
    q, k, v = _operands(3, t, h, kv, hd, torch.bfloat16, cuda, seed=hd)
    _hold(q, k, v, None)


@pytest.mark.cuda
def test_kernel_refuses_on_the_card(cuda):
    q, k, v = _operands(1, 64, 4, 4, 32, torch.float32, cuda)
    with pytest.raises(TypeError):
        prefill_attention(q, k, v)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    every_other = torch.cat([v, v], dim=-1)[..., ::2]     # last stride 2
    with pytest.raises(ValueError, match="operand v"):
        prefill_attention(q, k, every_other)
    with pytest.raises(ValueError, match="scale"):
        prefill_attention(q, k, v, scale=-0.1)


@pytest.mark.cuda
def test_a_full_width_zamba2_prefill_launches_it_per_hybrid_layer(cuda):
    cfg = get_config("zamba2-7b-instruct")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 4096), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    with torch.no_grad():
        logits, _ = model.prefill(params, tokens,
                                  model.init_cache(4, 4096, cuda))
    torch.cuda.synchronize()
    assert model.last_prefill_counts["prefill_attention"] == \
        len(cfg.hybrid_layer_ids) == 13
    assert bool(torch.isfinite(logits.float()).all())
    assert math.isfinite(float(logits.float().abs().max()))
