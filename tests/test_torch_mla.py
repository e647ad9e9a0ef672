"""The port's Multi-head Latent Attention against the reference's, on the CPU.

`flash_latent_full` / `flash_latent_decode` (small chunks, causal masks,
the chunk-multiple errors), `init_mla`'s tree, and `mla_full`,
`mla_prefill` and `mla_decode` in both of the reference's branches: the
dense (T, S) scores below its thresholds and the chunked flash walk at a
2048-token prefill and an 8192-position cache, at deepseek-v2-lite's
reduced widths (4 heads, kv_lora_rank 64, one rope head of 16).  Inputs
are numpy draws from a seed; weights carry across through
`params_from_numpy`.

Tolerances, relative to the largest |reference| value: fp32 1e-5; bf16
5e-2, the reference's own bf16 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxModelConfig
from repro.models import flash as jax_flash
from repro.models import mla as jax_mla

from repro_torch.models import flash, get_config, mla, params_from_numpy

from test_torch_models import JDT, TDT, both, close, normal


def reduced(dtype="float32"):
    cfg = dataclasses.replace(get_config("deepseek_v2_lite").reduced(),
                              dtype=dtype)
    return cfg, JaxModelConfig(**dataclasses.asdict(cfg))


def weights(dtype, seed=0):
    """init_mla's tree in both packages: the reference's draws, cast to
    `dtype` the same way in both."""
    cfg, jcfg = reduced(dtype)
    jp = jax_mla.init_mla(jax.random.PRNGKey(seed), jcfg, JDT[dtype])
    return cfg, jcfg, block_params(jp), jp


def block_params(jp, dtype=None):
    """One block's param dict (numpy leaves) as the port's tensors, through
    `params_from_numpy` (cast to `dtype` if given)."""
    ref = {"embed": np.zeros(1, np.float32), "unembed": np.zeros(1),
           "ln_f": np.zeros(1), "prologue": [jax.tree.map(np.asarray, jp)],
           "pattern": []}
    return params_from_numpy(ref, "cpu", dtype)["prologue"][0]


# ------------------------------------------------------------ latent flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,bq,bk", [(16, 4, 8), (24, 8, 4), (8, 8, 8)])
def test_flash_latent_full_is_the_reference(dtype, t, bq, bk):
    rng = np.random.default_rng(t + bq)
    b, h, r, rd = 2, 3, 16, 8
    jl, tl = both(normal(rng, b, t, h, r), dtype)
    jr, tr = both(normal(rng, b, t, h, rd), dtype)
    jc, tc = both(normal(rng, b, t, r), dtype)
    jk, tk = both(normal(rng, b, t, rd), dtype)
    got = flash.flash_latent_full(tl, tr, tc, tk, 0.2, bq=bq, bk=bk)
    assert got.dtype == TDT[dtype] and got.shape == (b, t, h, r)
    close(got, jax_flash.flash_latent_full(jl, jr, jc, jk, 0.2, bq=bq,
                                           bk=bk), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5, 17, 31])
def test_flash_latent_decode_is_the_reference(dtype, pos):
    rng = np.random.default_rng(pos)
    b, h, r, rd, s = 2, 4, 16, 8, 32
    jl, tl = both(normal(rng, b, 1, h, r), dtype)
    jr, tr = both(normal(rng, b, 1, h, rd), dtype)
    jc, tc = both(normal(rng, b, s, r), dtype)
    jk, tk = both(normal(rng, b, s, rd), dtype)
    got = flash.flash_latent_decode(tl, tr, tc, tk, pos, 0.3, bk=8)
    assert got.dtype == TDT[dtype] and got.shape == (b, 1, h, r)
    close(got, jax_flash.flash_latent_decode(jl, jr, jc, jk, jnp.int32(pos),
                                             0.3, bk=8), dtype)
    # a 0-d tensor position is the same position
    close(flash.flash_latent_decode(tl, tr, tc, tk, torch.tensor(pos), 0.3,
                                    bk=8), got.float().numpy(), dtype)


def test_flash_latent_needs_whole_chunks():
    z = torch.zeros
    with pytest.raises(ValueError, match="multiples of the chunks"):
        flash.flash_latent_full(z(1, 12, 2, 4), z(1, 12, 2, 2),
                                z(1, 12, 4), z(1, 12, 2), 1.0, bq=8, bk=4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        flash.flash_latent_decode(z(1, 1, 2, 4), z(1, 1, 2, 2),
                                  z(1, 12, 4), z(1, 12, 2), 3, 1.0, bk=8)


# --------------------------------------------------------------------- mla
def test_the_mla_thresholds_are_the_reference_thresholds():
    assert mla._FLASH_THRESHOLD == jax_mla._FLASH_THRESHOLD == 2048
    assert (mla._DECODE_FLASH_THRESHOLD
            == jax_mla._DECODE_FLASH_THRESHOLD == 8192)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_has_the_reference_tree(dtype):
    cfg, jcfg = reduced(dtype)
    want = jax_mla.init_mla(jax.random.PRNGKey(0), jcfg, JDT[dtype])
    got = mla.init_mla(torch.Generator().manual_seed(0), cfg, TDT[dtype])
    assert sorted(got) == sorted(want) == sorted(
        ["wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo", "kv_norm"])
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == TDT[dtype], k
        if k == "kv_norm":
            assert torch.equal(got[k], torch.ones_like(got[k]))
        else:
            ratio = float(got[k].float().std()) / float(
                np.asarray(w, np.float32).std())
            assert abs(ratio - 1) < 0.1, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [64, 2048])
def test_mla_full_and_prefill_are_the_reference(dtype, t):
    """T = 64 takes the dense scores, T = 2048 the chunked flash walk."""
    cfg, jcfg, tp, jp = weights(dtype)
    rng = np.random.default_rng(t)
    jx, tx = both(normal(rng, 1, t, cfg.d_model), dtype)
    want = jax_mla.mla_full(jp, jx, jcfg)
    close(mla.mla_full(tp, tx, cfg), want, dtype)
    out, (c_kv, k_rope) = mla.mla_prefill(tp, tx, cfg)
    jout, (jc, jk) = jax_mla.mla_prefill(jp, jx, jcfg)
    assert out.dtype == TDT[dtype]
    close(out, jout, dtype)
    close(c_kv, jc, dtype)
    close(k_rope, jk, dtype)


def test_the_flash_branch_is_the_dense_branch():
    """At T = 2048 the flash walk gives the dense scores' answer."""
    cfg, _, tp, _ = weights("float32")
    rng = np.random.default_rng(3)
    _, tx = both(normal(rng, 1, 2048, cfg.d_model))
    pos = torch.arange(2048).expand(1, 2048)
    q_nope, q_rope = mla._queries(tp, tx, cfg, pos)
    c_kv, k_rope = mla._latents(tp, tx, cfg, pos)
    ar = torch.arange(2048)
    dense = mla._attend_latent(tp, q_nope, q_rope, c_kv, k_rope,
                               ar[None, :] <= ar[:, None], cfg)
    close(mla.mla_full(tp, tx, cfg), dense.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,pos", [(64, 40), (64, 0), (8192, 5000),
                                   (8192, 8191)])
def test_mla_decode_is_the_reference(dtype, s, pos):
    """S = 64 takes the dense scores, S = 8192 the flash decode walk; the
    caches are written in place at `pos` and returned."""
    cfg, jcfg, tp, jp = weights(dtype)
    rng = np.random.default_rng(s + pos)
    b = 2
    jx, tx = both(normal(rng, b, 1, cfg.d_model), dtype)
    jc, tc = both(normal(rng, b, s, cfg.kv_lora_rank), dtype)
    jk, tk = both(normal(rng, b, s, cfg.qk_rope_head_dim), dtype)
    out, ckv, krope = mla.mla_decode(tp, tx, cfg, tc, tk, pos)
    jout, jckv, jkrope = jax_mla.mla_decode(jp, jx, jcfg, jc, jk,
                                            jnp.int32(pos))
    assert ckv is tc and krope is tk            # written in place
    assert out.dtype == TDT[dtype] and out.shape == (b, 1, cfg.d_model)
    close(out, jout, dtype)
    close(ckv, jckv, dtype)
    close(krope, jkrope, dtype)


def test_prefill_then_decode_equals_the_full_pass():
    """mla_prefill over T tokens, then one mla_decode step, gives
    mla_full's last row over T + 1 (dense branch, fp32)."""
    cfg, _, tp, _ = weights("float32")
    rng = np.random.default_rng(4)
    t, s = 40, 64
    _, tx = both(normal(rng, 2, t + 1, cfg.d_model))
    full = mla.mla_full(tp, tx, cfg)
    out, (c_kv, k_rope) = mla.mla_prefill(tp, tx[:, :t], cfg)
    cache_c = torch.zeros(2, s, cfg.kv_lora_rank)
    cache_k = torch.zeros(2, s, cfg.qk_rope_head_dim)
    cache_c[:, :t], cache_k[:, :t] = c_kv, k_rope
    step, _, _ = mla.mla_decode(tp, tx[:, t:], cfg, cache_c, cache_k,
                                torch.tensor(t))
    close(out, full[:, :t].numpy())
    close(step, full[:, t:].numpy())
