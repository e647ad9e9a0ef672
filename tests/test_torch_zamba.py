"""The port's Zamba2 hybrid against the reference's, on the CPU.

`init_mamba2`, `mamba2_state_shapes`, `_causal_depthwise_conv` and
`mamba2_mix` against `repro.models.ssm` on the same seeded numpy inputs:
T = 256 takes the reference's chunked branch, T = 7 its step scan and
T = 1 its decode step, while the port takes one `ssd_chunk_scan` call
for all three (on the CPU, the kernel's plain version in chunks of 64).
Then `ZambaModel` on reduced zamba2-7b with 4 layers (2 groups, so two
KV caches and two shared-attention applications): `forward`, `loss`,
`prefill` at T = 256 and T = 9, three `decode_step`s and every cache
entry, the reference's weights carried over by `params_from_numpy`; the
fixed-batch `ServingEngine`'s greedy tokens against the reference
engine's; the continuous scheduler's refusal; and `python -m repro_torch
serve --arch zamba2_7b` with jax and `repro` blocked.

Tolerances, relative to the largest |reference| value: fp32 1e-5 (the
same recurrence summed in another order: chunks of 64 against the
reference's chunks of 256 or its step scan); bf16 5e-2, the reference's
own bf16 tolerance (XLA and PyTorch round bf16 intermediates at other
places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.serving import ContinuousScheduler as JaxContinuousScheduler
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.models import (ZambaModel, build, build_model, get_config,
                                params_from_numpy)
from repro_torch.models import ssm
from repro_torch.serving import ContinuousScheduler, Request, ServingEngine

from test_torch_models import JDT, RTOL, TDT, both, close, normal
from test_torch_support import blocked_cli

FP32_LEAVES = ("A_log", "D", "dt_bias")
CPU = "cpu"


def reduced(dtype="bfloat16", **kw):
    cfg = dataclasses.replace(get_config("zamba2_7b").reduced(**kw),
                              dtype=dtype)
    return cfg, JaxModelConfig(**dataclasses.asdict(cfg))


# -------------------------------------------------------------- the mixer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba2_has_the_reference_shapes_and_dtypes(dtype):
    cfg, jcfg = reduced(dtype)
    want = jax_ssm.init_mamba2(jax.random.PRNGKey(0), jcfg, JDT[dtype])
    got = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg, TDT[dtype])
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
        assert v.device.type == "cpu"
    for k in FP32_LEAVES:
        assert got[k].dtype == torch.float32
    assert torch.equal(got["A_log"], torch.zeros_like(got["A_log"]))
    assert torch.equal(got["D"], torch.ones_like(got["D"]))
    # the scales: fan-in normals, the conv taps at 0.3
    d, d_in = cfg.d_model, cfg.ssm_expand * cfg.d_model
    for k, scale in (("w_in", d ** -0.5), ("conv_w", 0.3),
                     ("w_out", d_in ** -0.5)):
        assert abs(float(got[k].float().std()) / scale - 1.0) < 0.1, k


def test_mamba2_state_shapes_are_the_reference_shapes():
    for arch_cfg in (get_config("zamba2_7b"), reduced()[0]):
        jcfg = JaxModelConfig(**dataclasses.asdict(arch_cfg))
        for batch in (1, 4):
            assert (ssm.mamba2_state_shapes(arch_cfg, batch)
                    == jax_ssm.mamba2_state_shapes(jcfg, batch))
    # zamba2-7b at full width: H = 112 heads of 64, N = 64
    assert ssm.mamba2_state_shapes(get_config("zamba2_7b"), 1) == (
        (1, 112, 64, 64), (1, 3, 7296))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 2, 9])
def test_causal_depthwise_conv_carries_the_last_inputs(dtype, t):
    rng = np.random.default_rng(t)
    jx, tx = both(normal(rng, 2, t, 24), dtype)
    jw, tw = both(normal(rng, ssm._CONV_K, 24, scale=0.3), dtype)
    jc, tc = both(normal(rng, 2, ssm._CONV_K - 1, 24), dtype)
    want, want_carry = jax_ssm._causal_depthwise_conv(jx, jw, jc)
    got, carry = ssm._causal_depthwise_conv(tx, tw, tc)
    assert got.dtype == carry.dtype == TDT[dtype]
    close(got, want, dtype)
    close(carry, want_carry, dtype)
    # the carry is the last K-1 inputs, the old carry's tail included
    ext = torch.cat([tc, tx], dim=1)
    assert torch.equal(carry, ext[:, -(ssm._CONV_K - 1):])


def _mixer_params(rng, cfg, dtype):
    """Seeded Mamba2 params in both packages: nonzero A_log and dt_bias
    and D off 1, so every term of the recurrence is exercised."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n, h = cfg.ssm_state, d_in // cfg.ssm_head_dim
    arrays = {"w_in": normal(rng, d, 2 * d_in + 2 * n + h, scale=d ** -0.5),
              "conv_w": normal(rng, ssm._CONV_K, d_in + 2 * n, scale=0.3),
              "A_log": normal(rng, h, scale=0.5),
              "D": 1.0 + normal(rng, h, scale=0.1),
              "dt_bias": normal(rng, h, scale=0.5),
              "norm_z": 1.0 + normal(rng, d_in, scale=0.1),
              "w_out": normal(rng, d_in, d, scale=d_in ** -0.5)}
    jp, tp = {}, {}
    for k, a in arrays.items():
        jp[k], tp[k] = both(a, "float32" if k in FP32_LEAVES else dtype)
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [256, 7, 1],
                         ids=["chunked", "step-scan", "decode"])
def test_mamba2_mix_matches_the_reference(dtype, t):
    """y, the final state and the new carry.  The reference takes its
    chunked branch at T = 256 and its step scan at T = 7 and 1; the
    port's one SSD call agrees with both at the fp32 bound."""
    cfg, jcfg = reduced(dtype)
    rng = np.random.default_rng(100 + t)
    jp, tp = _mixer_params(rng, cfg, dtype)
    (s_shape, c_shape) = ssm.mamba2_state_shapes(cfg, 2)
    jx, tx = both(normal(rng, 2, t, cfg.d_model), dtype)
    js, ts = both(normal(rng, *s_shape, scale=0.5))
    jc, tc = both(normal(rng, *c_shape), dtype)
    want = jax_ssm.mamba2_mix(jp, jx, jcfg, js, jc)
    got = ssm.mamba2_mix(tp, tx, cfg, ts, tc)
    assert [g.dtype for g in got] == [TDT[dtype], torch.float32, TDT[dtype]]
    for g, w in zip(got, want):
        close(g, w, dtype)


def test_mamba2_mix_calls_the_ssd_kernel_once(monkeypatch):
    """Its SSD core is one `ssd_chunk_scan` call, on contiguous fp32
    operands, whatever T is."""
    cfg, _ = reduced("bfloat16")
    rng = np.random.default_rng(7)
    _, tp = _mixer_params(rng, cfg, "bfloat16")
    (s_shape, c_shape) = ssm.mamba2_state_shapes(cfg, 1)
    seen = []
    real = ssm.ssd_chunk_scan

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(ssm, "ssd_chunk_scan", spy)
    for t in (1, 20, 300):
        x = torch.from_numpy(normal(rng, 1, t, cfg.d_model)).bfloat16()
        ssm.mamba2_mix(tp, x, cfg, torch.zeros(s_shape),
                       torch.zeros(c_shape, dtype=torch.bfloat16))
    assert len(seen) == 3
    for args in seen:
        assert all(a.is_contiguous() and a.dtype == torch.float32
                   for a in args)


# --------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def ref_weights():
    """The reference's fp32 weights of reduced zamba2-7b with 4 layers (2
    groups of 2), numpy leaves; drawn once for every test below."""
    _, jcfg = reduced("float32", n_layers=4)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jparams)


def _in_dtype(tree, dtype):
    """Numpy leaves rounded to `dtype` as the reference rounds them, the
    Mamba2 fp32 leaves kept."""
    if isinstance(tree, dict):
        return {k: (v if k in FP32_LEAVES else _in_dtype(v, dtype))
                for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, JDT[dtype]))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def zamba(request, ref_weights):
    """The reduced model in one dtype, the same weights in both packages;
    the reference's entry points jitted."""
    dtype = request.param
    cfg, jcfg = reduced(dtype, n_layers=4)
    jmodel = jax_build_model(jcfg)
    weights = _in_dtype(ref_weights, dtype)
    jparams = jax.tree.map(jnp.asarray, weights)
    params = params_from_numpy(weights, CPU)
    ref = dict(forward=jax.jit(jmodel.forward), loss=jax.jit(jmodel.loss),
               prefill=jax.jit(jmodel.prefill),
               decode=jax.jit(jmodel.decode_step))
    return dtype, (cfg, build_model(cfg), params), (jmodel, jparams, ref)


def test_build_gives_the_zamba_model():
    cfg, model = build("zamba2-7b")
    assert isinstance(model, ZambaModel)
    assert (model.n_groups, cfg.attn_every, cfg.n_layers) == (9, 9, 81)
    assert not getattr(model, "pad_aware", False)
    assert not getattr(model, "per_slot_pos", False)
    assert 6.6e9 < cfg.param_count() < 6.7e9


def test_params_carry_over_in_the_port_layout(zamba):
    dtype, (cfg, model, params), (_, jparams, _) = zamba
    own = model.init(torch.Generator().manual_seed(0))
    assert len(params["mamba"]) == model.n_groups == 2
    assert all(len(g) == cfg.attn_every == 2 for g in params["mamba"])

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(params) == shapes(own)
    for g in range(2):
        for k in range(2):
            mixer = params["mamba"][g][k]["mixer"]
            np.testing.assert_array_equal(
                mixer["w_in"].float().numpy(),
                np.asarray(jparams["mamba"]["mixer"]["w_in"][g, k],
                           np.float32))
    # a dtype cast leaves the fp32 SSM leaves in fp32
    cast = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU,
                             dtype=torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    mixer = cast["mamba"][1][0]["mixer"]
    assert mixer["w_in"].dtype == cast["shared_attn"]["attn"]["wq"].dtype \
        == torch.bfloat16
    assert all(mixer[k].dtype == torch.float32 for k in FP32_LEAVES)


def test_forward_and_loss_match_the_reference(zamba):
    dtype, (cfg, model, params), (_, jparams, ref) = zamba
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jt, tt = both(toks)
    jl, tl = both(labels)
    want, want_aux = ref["forward"](jparams, jt)
    got, aux = model.forward(params, tt)
    assert got.dtype == TDT[dtype] and float(aux) == float(want_aux) == 0.0
    close(got, want, dtype)
    close(model.loss(params, {"tokens": tt, "labels": tl}),
          ref["loss"](jparams, {"tokens": jt, "labels": jl}), dtype)


@pytest.mark.parametrize("t", [256, 9], ids=["chunked", "step-scan"])
def test_prefill_decode_and_caches_match_the_reference(zamba, t):
    """Prefill (the reference's chunked branch at T = 256, its step scan
    at T = 9), three decode steps at the shared position, and after each
    every cache entry: both KV caches and each layer's SSM state and conv
    carry, in their dtypes."""
    dtype, (cfg, model, params), (jmodel, jparams, ref) = zamba
    rng = np.random.default_rng(t)
    max_len = 264
    toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    jt, tt = both(toks)
    jcache = jmodel.init_cache(2, max_len)
    cache = model.init_cache(2, max_len, device=CPU)
    assert cache["ssm"][0][0].dtype == torch.float32
    assert cache["conv"][0][0].dtype == cache["attn_k"][0].dtype \
        == TDT[dtype]
    want, jcache = ref["prefill"](jparams, jt, jcache)
    got, cache = model.prefill(params, tt, cache)
    close(got, want, dtype)

    def caches_close():
        for g in range(model.n_groups):
            close(cache["attn_k"][g], jcache["attn_k"][g], dtype)
            close(cache["attn_v"][g], jcache["attn_v"][g], dtype)
            for k in range(cfg.attn_every):
                close(cache["ssm"][g][k], jcache["ssm"][g, k], dtype)
                close(cache["conv"][g][k], jcache["conv"][g, k], dtype)

    caches_close()
    for i in range(3):
        step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        js, ts = both(step)
        want, jcache = ref["decode"](jparams, js, jcache, jnp.int32(t + i))
        got, cache = model.decode_step(params, ts, cache, t + i)
        assert got.shape == (2, cfg.vocab_size)
        close(got, want, dtype)
        caches_close()


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def zamba_fp32(ref_weights):
    cfg, jcfg = reduced("float32", n_layers=4)
    return ((cfg, build_model(cfg), params_from_numpy(ref_weights, CPU)),
            (jcfg, jax_build_model(jcfg),
             jax.tree.map(jnp.asarray, ref_weights)))


def test_fixed_batch_engine_tokens_equal_the_reference(zamba_fp32):
    """Greedy completions of a left-padded mixed-length batch: Zamba is
    not pad-aware in either package, so the pads run through the SSM in
    both and the tokens still agree."""
    (cfg, model, params), (jcfg, jmodel, jparams) = zamba_fp32
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    got = ServingEngine(cfg, model, params, max_batch=2, max_len=24,
                        device=CPU).run(reqs)
    want = JaxServingEngine(jcfg, jmodel, jparams, max_batch=2,
                            max_len=24).run(jreqs)
    assert [(c.rid, c.tokens) for c in got] == \
        [(c.rid, c.tokens) for c in want]


def test_continuous_scheduler_refuses_zamba_as_the_reference(zamba_fp32):
    (cfg, model, params), (jcfg, jmodel, jparams) = zamba_fp32
    with pytest.raises(ValueError) as want:
        JaxContinuousScheduler(jcfg, jmodel, jparams)
    with pytest.raises(ValueError) as got:
        ContinuousScheduler(cfg, model, params, device=CPU)
    assert str(got.value) == str(want.value)
    assert "per-slot position" in str(got.value)


def test_serve_cli_runs_zamba_on_the_cpu(tmp_path):
    out = blocked_cli(["serve", "--arch", "zamba2_7b", "--reduced",
                       "--torch-device", "cpu", "--requests", "4",
                       "--max-new", "3"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "4 completions, 12 tokens" in out.stdout
    assert "tok/s on cpu" in out.stdout
    refused = blocked_cli(["serve", "--arch", "zamba2_7b", "--reduced",
                           "--torch-device", "cpu", "--arrivals",
                           "poisson", "--requests", "4"], tmp_path)
    assert refused.returncode == 2
    assert "per-slot position" in refused.stderr
    assert "served" not in refused.stdout
