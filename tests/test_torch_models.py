"""The port's dense transformer models against the reference's, on the CPU.

`ModelConfig` accounting and `reduced()` for every configuration; the
layer functions (`rms_norm`, RoPE, the masks, the GQA score core, the
full, prefill and decode attention paths, the MLP) and the chunked
`flash_full` / `flash_decode` against the reference's on the same
seeded numpy inputs; and `TransformerModel.forward / prefill /
decode_step / loss` on reduced codeqwen1.5-7b, qwen2.5-32b (two query
heads per KV head), chameleon-34b (qk-norm) and gemma3-12b (local and
global layers), with the reference's weights carried over by
`params_from_numpy`.

Tolerances, relative to the largest |reference| value: fp32 1e-5 (the
same ops summed in another order); bf16 5e-2, the reference's own bf16
tolerance (XLA and PyTorch round bf16 intermediates at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models import flash as jax_flash
from repro.models import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.models.transformer import layer_program as jax_layer_program

from repro_torch.models import (ARCH_IDS, TransformerModel, build,
                                build_model, get_config, params_from_numpy)
from repro_torch.models import flash, layers
from repro_torch.models.transformer import layer_program

RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, dtype="float32"):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float32) - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= RTOL[dtype] * scale, f"max |err| {err:.3e} vs {scale:.3e}"


def both(a, dtype="float32"):
    """One numpy array as a reference array and a port tensor, rounded to
    `dtype` the same way in both."""
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return jnp.asarray(a), torch.from_numpy(a.copy())
    return (jnp.asarray(a, JDT[dtype]),
            torch.from_numpy(a.astype(np.float32)).to(TDT[dtype]))


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------------- configs
def test_the_port_names_the_reference_architectures():
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_reduced_equal_the_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.is_moe == ref.is_moe
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for kw in ({}, dict(n_layers=6), dict(n_layers=3, d_model=128,
                                           n_experts=2, vocab=64)):
        assert (dataclasses.asdict(cfg.reduced(**kw))
                == dataclasses.asdict(ref.reduced(**kw)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_program_is_the_reference_program(arch):
    for cfg, ref in ((get_config(arch), jax_get_config(arch)),
                     (get_config(arch).reduced(),
                      jax_get_config(arch).reduced())):
        pro, pat, n = layer_program(cfg)
        jpro, jpat, jn = jax_layer_program(ref)
        assert n == jn
        assert ([dataclasses.astuple(k) for k in pro + pat]
                == [dataclasses.astuple(k) for k in jpro + jpat])


def test_codeqwen_full_width_counts():
    cfg = get_config("codeqwen1.5-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 128, 13440, 92416)
    assert 8.0e9 < cfg.param_count() < 8.4e9


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_builds(arch):
    """Every family of the reference has its model in the port: the
    registry builds each configuration, the model class the reference's
    registry picks (by name) with its config."""
    cfg, model = build(arch)
    want = jax_build_model(jax_get_config(arch))
    assert type(model).__name__ == type(want).__name__
    assert model.cfg == cfg


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(1)
    jx, tx = both(normal(rng, 2, 5, 3, 16, scale=3.0), dtype)
    js, ts = both(1.0 + normal(rng, 16, scale=0.1), dtype)
    got = layers.rms_norm(tx, ts, 1e-5)
    assert got.dtype == TDT[dtype]
    close(got, jax_layers.rms_norm(jx, js, 1e-5), dtype)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    jp, tp = both(pos)
    for theta in (1e4, 1e6):
        got = layers.apply_rope(tx, tp, theta)
        assert got.dtype == TDT[dtype]
        close(got, jax_layers.apply_rope(jx, jp, theta), dtype)
    close(layers.rope_frequencies(64, 1e6),
          jax_layers.rope_frequencies(64, 1e6))


@pytest.mark.parametrize("q_len,k_len,offset,window", [
    (5, 5, 0, 0), (3, 9, 6, 0), (7, 7, 0, 3), (1, 16, 15, 4)])
def test_causal_mask(q_len, k_len, offset, window):
    got = layers._causal_mask(q_len, k_len, offset, window)
    want = jax_layers._causal_mask(q_len, k_len, offset, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row_mask", [False, True])
def test_attention_scores_gqa(dtype, per_row_mask):
    rng = np.random.default_rng(2)
    b, t, s, h, kv, hd = 2, 4, 6, 8, 2, 16
    jq, tq = both(normal(rng, b, t, h, hd), dtype)
    jk, tk = both(normal(rng, b, s, kv, hd), dtype)
    jv, tv = both(normal(rng, b, s, kv, hd), dtype)
    mask = rng.random((b, t, s) if per_row_mask else (t, s)) < 0.7
    mask[..., 0] = True
    if per_row_mask:
        mask[1, 2] = False                    # a fully masked row: uniform
    jm, tm = both(mask)
    got = layers.attention_scores(tq, tk, tv, tm)
    assert got.dtype == TDT[dtype] and bool(torch.isfinite(got).all())
    close(got, jax_layers.attention_scores(jq, jk, jv, jm), dtype)


def _spec_pair(**kw):
    return layers.AttnSpec(**kw), jax_layers.AttnSpec(**kw)


def _attn_params(rng, d, spec, dtype):
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
              "wo": (h * hd, d)}
    if spec.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
    if spec.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    jp, tp = {}, {}
    for name, shape in shapes.items():
        scale = 0.1 if name.startswith("b") else 1 / np.sqrt(shape[0])
        a = normal(rng, *shape, scale=scale)
        if name.endswith("norm"):
            a = 1.0 + a
        jp[name], tp[name] = both(a, dtype)
    return jp, tp


ATTN_SPECS = {
    "gqa g=2 bias": dict(n_heads=4, n_kv_heads=2, head_dim=16,
                         qkv_bias=True, rope_theta=1e6),
    "mha qk-norm": dict(n_heads=4, n_kv_heads=4, head_dim=8, qk_norm=True),
    "g=4 window": dict(n_heads=8, n_kv_heads=2, head_dim=8,
                       sliding_window=3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ATTN_SPECS))
def test_attention_full_and_prefill(name, dtype):
    rng = np.random.default_rng(3)
    spec, jspec = _spec_pair(**ATTN_SPECS[name])
    d, b, t = 32, 3, 7
    jp, tp = _attn_params(rng, d, spec, dtype)
    jx, tx = both(normal(rng, b, t, d), dtype)
    close(layers.attention_full(tp, tx, spec),
          jax_layers.attention_full(jp, jx, jspec), dtype)
    for start in (None, np.array([0, 2, 5], np.int32)):
        js, ts = (None, None) if start is None else both(start)
        out, (k, v) = layers.attention_prefill(tp, tx, spec, start=ts)
        jout, (jk, jv) = jax_layers.attention_prefill(jp, jx, jspec,
                                                      start=js)
        close(out, jout, dtype)
        close(k, jk, dtype)
        close(v, jv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ATTN_SPECS))
@pytest.mark.parametrize("how", ["scalar", "scalar past the end", "per row",
                                 "per row with start", "per row past the "
                                 "end"])
def test_attention_decode(name, dtype, how):
    rng = np.random.default_rng(4)
    spec, jspec = _spec_pair(**ATTN_SPECS[name])
    d, b, s = 32, 3, 12
    kv, hd = spec.n_kv_heads, spec.head_dim
    jp, tp = _attn_params(rng, d, spec, dtype)
    jx, tx = both(normal(rng, b, 1, d), dtype)
    ck, cv = normal(rng, b, s, kv, hd), normal(rng, b, s, kv, hd)
    start = None
    if how.startswith("scalar"):
        pos = 7 if how == "scalar" else s + 3     # the write clamps
        jpos, tpos = jnp.int32(pos), pos
    else:
        pos = np.array([3, 11, 6], np.int32)
        if how.endswith("past the end"):
            pos[1] = s + 2                        # that row's write drops
        jpos, tpos = both(pos)
        if how.endswith("start"):
            start = np.array([0, 4, 2], np.int32)
    js, ts = (None, None) if start is None else both(start)
    jck, tck = both(ck, dtype)
    jcv, tcv = both(cv, dtype)
    out, k2, v2 = layers.attention_decode(tp, tx, spec, tck, tcv, tpos,
                                          start=ts)
    jout, jk2, jv2 = jax_layers.attention_decode(jp, jx, jspec, jck, jcv,
                                                 jpos, start=js)
    close(out, jout, dtype)
    close(k2, jk2, dtype)
    close(v2, jv2, dtype)
    assert k2 is tck and v2 is tcv                 # written in place


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    rng = np.random.default_rng(5)
    d, ff = 32, 48
    jp, tp = {}, {}
    for name, shape in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                        ("w_down", (ff, d))):
        jp[name], tp[name] = both(normal(rng, *shape,
                                         scale=shape[0] ** -0.5), dtype)
    jx, tx = both(normal(rng, 2, 3, d), dtype)
    close(layers.mlp(tp, tx), jax_layers.mlp(jp, jx), dtype)


@pytest.mark.parametrize("h,kv,window,bq,bk", [
    (4, 2, 0, 4, 4), (4, 4, 3, 8, 2), (8, 2, 5, 2, 8)])
def test_flash_full_is_the_reference_and_the_dense_path(h, kv, window, bq,
                                                        bk):
    rng = np.random.default_rng(6)
    b, t, hd = 2, 16, 8
    jq, tq = both(normal(rng, b, t, h, hd))
    jk, tk = both(normal(rng, b, t, kv, hd))
    jv, tv = both(normal(rng, b, t, kv, hd))
    got = flash.flash_full(tq, tk, tv, window=window, bq=bq, bk=bk)
    close(got, jax_flash.flash_full(jq, jk, jv, window=window, bq=bq, bk=bk))
    dense = layers.attention_scores(
        tq, tk, tv, layers._causal_mask(t, t, window=window))
    close(got, dense.numpy())


@pytest.mark.parametrize("h,kv,pos,window,bk", [
    (4, 2, 13, 0, 4), (4, 4, 5, 3, 8), (8, 2, 31, 6, 16)])
def test_flash_decode_is_the_reference_and_the_dense_path(h, kv, pos,
                                                          window, bk):
    rng = np.random.default_rng(7)
    b, s, hd = 2, 32, 8
    jq, tq = both(normal(rng, b, 1, h, hd))
    jk, tk = both(normal(rng, b, s, kv, hd))
    jv, tv = both(normal(rng, b, s, kv, hd))
    got = flash.flash_decode(tq, tk, tv, pos, window=window, bk=bk)
    close(got, jax_flash.flash_decode(jq, jk, jv, pos, window=window,
                                      bk=bk))
    k_pos = torch.arange(s)
    mask = k_pos <= pos
    if window:
        mask &= k_pos > pos - window
    close(got, layers.attention_scores(tq, tk, tv, mask[None]).numpy())


def test_the_flash_thresholds_are_the_reference_thresholds():
    assert layers.FLASH_THRESHOLD == jax_layers.FLASH_THRESHOLD
    assert (layers.DECODE_FLASH_THRESHOLD
            == jax_layers.DECODE_FLASH_THRESHOLD)


# ------------------------------------------------------------------- model
def _reduced(arch):
    cfg = get_config(arch)
    if arch == "gemma3_12b":
        return cfg.reduced(n_layers=6)
    cfg = cfg.reduced()
    if arch == "qwen25_32b":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)   # two heads per KV
    return cfg


MODELS = ["codeqwen15_7b", "qwen25_32b", "chameleon_34b", "gemma3_12b"]


@pytest.fixture(scope="module")
def models():
    """Each reduced model in both packages, fp32 and bf16, with the
    reference's weights (fp32 draws cast to bf16 in both)."""
    out = {}
    for arch in MODELS:
        cfg = _reduced(arch)
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype)
            rc = JaxModelConfig(**dataclasses.asdict(c))
            jm = jax_build_model(rc)
            jp = jm.init(jax.random.PRNGKey(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
            out[arch, dtype] = (c, build_model(c), tp, jm, jp)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODELS)
def test_forward_and_loss(models, arch, dtype):
    cfg, m, tp, jm, jp = models[arch, dtype]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    logits, aux = m.forward(tp, torch.from_numpy(toks))
    jlogits, _ = jm.forward(jp, jnp.asarray(toks))
    assert logits.dtype == TDT[dtype] and float(aux) == 0.0
    close(logits, jlogits, dtype)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss = m.loss(tp, batch)
    jloss = jm.loss(jp, {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(labels)})
    close(loss, jloss, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODELS)
def test_prefill_then_decode(models, arch, dtype):
    """A left-padded prefill, two decode steps at a shared position, then
    two with a (B,) position vector: logits and caches as the
    reference's."""
    cfg, m, tp, jm, jp = models[arch, dtype]
    rng = np.random.default_rng(9)
    b, t, s = 3, 9, 24
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    start = np.array([0, 3, 6], np.int32)
    js, ts = both(start)
    cache = m.init_cache(b, s, device="cpu")
    jcache = jm.init_cache(b, s)
    logits, cache = m.prefill(tp, torch.from_numpy(toks), cache, start=ts)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(toks), jcache, start=js)
    close(logits, jlogits, dtype)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        if step < 2:
            pos, jpos = t + step, jnp.int32(t + step)
        else:
            p = np.array([t + step, t + step + 3, t + step + 1], np.int32)
            jpos, pos = both(p)
        logits, cache = m.decode_step(tp, torch.from_numpy(tok), cache, pos,
                                      start=ts)
        jlogits, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, jpos,
                                         start=js)
        close(logits, jlogits, dtype)
    # the caches: the reference stacks each pattern position over repeats
    for j, stacked in enumerate(jcache["pattern"]):
        for r, (k, v) in enumerate(cache["pattern"][j]):
            close(k, stacked[0][r], dtype)
            close(v, stacked[1][r], dtype)


def test_unpadded_prefill_and_decode_without_start(models):
    cfg, m, tp, jm, jp = models["codeqwen15_7b", "float32"]
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    logits, cache = m.prefill(tp, torch.from_numpy(toks),
                              m.init_cache(2, 8, device="cpu"))
    jlogits, jcache = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(2, 8))
    close(logits, jlogits)
    tok = toks[:, :1]
    logits, _ = m.decode_step(tp, torch.from_numpy(tok), cache,
                              torch.tensor(5))
    jlogits, _ = jm.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(5))
    close(logits, jlogits)


@pytest.mark.parametrize("arch", MODELS)
def test_init_draws_the_reference_shapes_and_scales(models, arch):
    cfg, m, tp, jm, jp = models[arch, "float32"]
    params = m.init(torch.Generator().manual_seed(0))
    again = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(params["embed"], again["embed"])   # seeded
    ref = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    got, want = dict(leaves(params)), dict(leaves(ref))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.numel() > 1000:                    # the draws' scale
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.1, path
        else:                                   # ones and zeros
            if float(w.std()) == 0.0:
                assert torch.equal(g, w), path


def test_the_model_runs_in_bf16_by_default():
    cfg = get_config("codeqwen15_7b").reduced()
    m = TransformerModel(cfg)
    p = m.init(torch.Generator().manual_seed(1))
    assert p["embed"].dtype == torch.bfloat16
    logits, _ = m.prefill(p, torch.zeros(1, 3, dtype=torch.long),
                          m.init_cache(1, 4, device="cpu"))
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 512)
    if not torch.cuda.is_available():       # the cache defaults to the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            m.init_cache(1, 4)
