"""The port's RWKV6 against the reference's, on the CPU.

`init_rwkv6`, `init_rwkv_channel_mix`, `rwkv6_state_shapes`, `rwkv6_mix`
and `rwkv_channel_mix` against `repro.models.ssm` on the same seeded numpy
inputs: T = 128 takes both packages' chunked WKV (T >= 64, T % 64 == 0),
T = 100 their step recurrence.  The port's chunked WKV against its own
step recurrence, with a strong decay.  Then `RWKVModel` on reduced
rwkv6-1.6b (2 layers, d_model 256, heads of 32): `forward`, `loss`,
`prefill` at T = 128 and T = 9, three `decode_step`s and every cache
entry, the reference's weights carried over by `params_from_numpy`;
prefill then decode against `forward` over the whole sequence (the token
shift carried across calls); the fixed-batch `ServingEngine`'s greedy
tokens against the reference engine's; the continuous scheduler's
refusal; and `python -m repro_torch serve --arch rwkv6_1b6` with jax and
`repro` blocked.

Tolerances, relative to the largest |reference| value: fp32 1e-5 (the
same arithmetic, summed in another order by another framework); bf16
5e-2, the reference's own bf16 tolerance (XLA and PyTorch round bf16
intermediates at other places).
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

from repro_torch.models import (RWKVModel, build, build_model, get_config,
                                params_from_numpy)
from repro_torch.models import ssm
from repro_torch.serving import ContinuousScheduler, Request, ServingEngine

from test_torch_models import JDT, TDT, both, close, normal
from test_torch_support import blocked_cli

FP32_LEAVES = ("w0", "u")
CPU = "cpu"


def reduced(dtype="bfloat16", **kw):
    cfg = dataclasses.replace(get_config("rwkv6_1b6").reduced(**kw),
                              dtype=dtype)
    return cfg, JaxModelConfig(**dataclasses.asdict(cfg))


def _dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


# ------------------------------------------------------------- the mixers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv6_has_the_reference_shapes_and_dtypes(dtype):
    cfg, jcfg = reduced(dtype)
    want = jax_ssm.init_rwkv6(jax.random.PRNGKey(0), jcfg, JDT[dtype])
    got = ssm.init_rwkv6(torch.Generator().manual_seed(0), cfg, TDT[dtype])
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert _dtype_name(v) == str(want[k].dtype), k
        assert v.device.type == "cpu"
    for k in FP32_LEAVES:
        assert got[k].dtype == torch.float32
    assert torch.equal(got["w0"], torch.full_like(got["w0"], -6.0))
    assert torch.equal(got["ln_x"], torch.ones_like(got["ln_x"]))
    mix = got["mix"].float()
    assert 0.0 <= float(mix.min()) and float(mix.max()) < 1.0
    d = cfg.d_model
    for k, scale in (("wr", d ** -0.5), ("wo", d ** -0.5),
                     ("w_a", d ** -0.5), ("w_b", 32 ** -0.5), ("u", 0.1)):
        assert abs(float(got[k].float().std()) / scale - 1.0) < 0.15, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv_channel_mix_has_the_reference_shapes_and_dtypes(dtype):
    cfg, jcfg = reduced(dtype)
    want = jax_ssm.init_rwkv_channel_mix(jax.random.PRNGKey(0), jcfg,
                                         JDT[dtype])
    got = ssm.init_rwkv_channel_mix(torch.Generator().manual_seed(0), cfg,
                                    TDT[dtype])
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert _dtype_name(v) == str(want[k].dtype), k
    d, ff = cfg.d_model, cfg.d_ff
    for k, scale in (("wk", d ** -0.5), ("wv", ff ** -0.5)):
        assert abs(float(got[k].float().std()) / scale - 1.0) < 0.1, k


def test_rwkv6_state_shapes_are_the_reference_shapes():
    for arch_cfg in (get_config("rwkv6_1b6"), reduced()[0]):
        jcfg = JaxModelConfig(**dataclasses.asdict(arch_cfg))
        for batch in (1, 4):
            assert (ssm.rwkv6_state_shapes(arch_cfg, batch)
                    == jax_ssm.rwkv6_state_shapes(jcfg, batch))
    # rwkv6-1.6b at full width: 32 heads of 64
    assert ssm.rwkv6_state_shapes(get_config("rwkv6_1b6"), 2) == (
        (2, 32, 64, 64), (2, 2048))


def _time_mix_params(rng, cfg, dtype):
    """Seeded RWKV6 time-mix params in both packages: a decay bias spread
    over strong and weak decay and a larger bonus, so every term of the
    recurrence and the chunked form's re-centering is exercised."""
    d = cfg.d_model
    h = d // cfg.ssm_head_dim
    arrays = {"mix": rng.uniform(0, 1, (5, d)).astype(np.float32),
              "w0": rng.uniform(-5.0, 1.0, d).astype(np.float32),
              "w_a": normal(rng, d, 32, scale=d ** -0.5),
              "w_b": normal(rng, 32, d, scale=32 ** -0.5),
              "u": normal(rng, h, cfg.ssm_head_dim, scale=0.5),
              "ln_x": 1.0 + normal(rng, d, scale=0.1)}
    for k in ("wr", "wk", "wv", "wg", "wo"):
        arrays[k] = normal(rng, d, d, scale=d ** -0.5)
    jp, tp = {}, {}
    for k, a in arrays.items():
        jp[k], tp[k] = both(a, "float32" if k in FP32_LEAVES else dtype)
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 100], ids=["chunked", "step"])
def test_rwkv6_mix_matches_the_reference(dtype, t):
    """y, the final WKV state and the token-shift carry, from a nonzero
    state and carry.  Both packages take the chunked WKV at T = 128 and
    the step recurrence at T = 100."""
    cfg, jcfg = reduced(dtype)
    rng = np.random.default_rng(200 + t)
    jp, tp = _time_mix_params(rng, cfg, dtype)
    s_shape, x_shape = ssm.rwkv6_state_shapes(cfg, 2)
    jx, tx = both(normal(rng, 2, t, cfg.d_model), dtype)
    js, ts = both(normal(rng, *s_shape, scale=0.5))
    jl, tl = both(normal(rng, *x_shape), dtype)
    want = jax_ssm.rwkv6_mix(jp, jx, jcfg, js, jl)
    got = ssm.rwkv6_mix(tp, tx, cfg, ts, tl)
    assert [g.dtype for g in got] == [TDT[dtype], torch.float32, TDT[dtype]]
    for g, w in zip(got, want):
        close(g, w, dtype)
    assert torch.equal(got[2], tx[:, -1])


@pytest.mark.parametrize("t", [64, 128, 100, 63, 1])
def test_rwkv6_mix_takes_the_reference_branch(monkeypatch, t):
    """The chunked WKV exactly where T >= 64 and T % 64 == 0, the step
    recurrence otherwise."""
    cfg, _ = reduced("float32")
    rng = np.random.default_rng(t)
    _, tp = _time_mix_params(rng, cfg, "float32")
    s_shape, x_shape = ssm.rwkv6_state_shapes(cfg, 1)
    chunked, steps = [], []
    real_chunked, real_step = ssm._wkv_chunked, ssm._wkv_step
    monkeypatch.setattr(ssm, "_wkv_chunked", lambda *a: (
        chunked.append(1), real_chunked(*a))[1])
    monkeypatch.setattr(ssm, "_wkv_step", lambda *a: (
        steps.append(1), real_step(*a))[1])
    x = torch.from_numpy(normal(rng, 1, t, cfg.d_model))
    ssm.rwkv6_mix(tp, x, cfg, torch.zeros(s_shape), torch.zeros(x_shape))
    takes_chunked = t >= ssm._WKV_CHUNK and t % ssm._WKV_CHUNK == 0
    assert (len(chunked), len(steps)) == ((1, 0) if takes_chunked
                                          else (0, t))


@pytest.mark.parametrize("t", [64, 192])
def test_wkv_chunked_matches_the_step_recurrence(t):
    """The port's chunked WKV against its own step recurrence on the same
    fp32 operands, under decay from strong (w near 0) to weak (near 1):
    the sub-chunk re-centering keeps every exponent bounded."""
    rng = np.random.default_rng(t)
    b, h, hd = 2, 3, 16
    r, k, v = (torch.from_numpy(normal(rng, b, t, h, hd)) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(rng.uniform(-6.0, 2.5, (
        b, t, h, hd)))).astype(np.float32))
    u = torch.from_numpy(normal(rng, h, hd, scale=0.5))
    s0 = torch.from_numpy(normal(rng, b, h, hd, hd, scale=0.5))
    state, outs = s0, []
    for i in range(t):
        state, out = ssm._wkv_step(state, (r[:, i], k[:, i], v[:, i],
                                           w[:, i]), u)
        outs.append(out)
    got_state, got = ssm._wkv_chunked(r, k, v, w, u, s0)
    assert torch.isfinite(got).all() and torch.isfinite(got_state).all()
    close(got, torch.stack(outs, dim=1).numpy())
    close(got_state, state.numpy())
    # and the reference's chunked form on the same operands
    jstate, jout = jax_ssm._wkv_chunked(*(jnp.asarray(a.numpy()) for a in
                                          (r, k, v, w, u, s0)))
    close(got, jout)
    close(got_state, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [7, 1])
def test_rwkv_channel_mix_matches_the_reference(dtype, t):
    cfg, _ = reduced(dtype)
    rng = np.random.default_rng(300 + t)
    d, ff = cfg.d_model, cfg.d_ff
    arrays = {"mix_k": rng.uniform(0, 1, d).astype(np.float32),
              "wk": normal(rng, d, ff, scale=d ** -0.5),
              "wv": normal(rng, ff, d, scale=ff ** -0.5)}
    jp, tp = {}, {}
    for k, a in arrays.items():
        jp[k], tp[k] = both(a, dtype)
    jx, tx = both(normal(rng, 2, t, d), dtype)
    jl, tl = both(normal(rng, 2, d), dtype)
    want = jax_ssm.rwkv_channel_mix(jp, jx, jl)
    got = ssm.rwkv_channel_mix(tp, tx, tl)
    assert [g.dtype for g in got] == [TDT[dtype]] * 2
    for g, w in zip(got, want):
        close(g, w, dtype)


# --------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def ref_weights():
    """The reference's fp32 weights of reduced rwkv6-1.6b (2 layers),
    numpy leaves; drawn once for every test below."""
    _, jcfg = reduced("float32")
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jparams)


def _in_dtype(tree, dtype):
    """Numpy leaves rounded to `dtype` as the reference rounds them, the
    RWKV6 fp32 leaves kept."""
    if isinstance(tree, dict):
        return {k: (v if k in FP32_LEAVES else _in_dtype(v, dtype))
                for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, JDT[dtype]))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def rwkv(request, ref_weights):
    """The reduced model in one dtype, the same weights in both packages;
    the reference's entry points jitted."""
    dtype = request.param
    cfg, jcfg = reduced(dtype)
    jmodel = jax_build_model(jcfg)
    weights = _in_dtype(ref_weights, dtype)
    jparams = jax.tree.map(jnp.asarray, weights)
    params = params_from_numpy(weights, CPU)
    ref = dict(forward=jax.jit(jmodel.forward), loss=jax.jit(jmodel.loss),
               prefill=jax.jit(jmodel.prefill),
               decode=jax.jit(jmodel.decode_step))
    return dtype, (cfg, build_model(cfg), params), (jmodel, jparams, ref)


def test_build_gives_the_rwkv_model():
    cfg, model = build("rwkv6-1.6b")
    assert isinstance(model, RWKVModel)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_head_dim, cfg.d_ff,
            cfg.vocab_size) == (24, 2048, 64, 7168, 65536)
    assert not getattr(model, "pad_aware", False)
    assert not getattr(model, "per_slot_pos", False)
    assert 1.40e9 < cfg.param_count() < 1.41e9


def test_params_carry_over_in_the_port_layout(rwkv):
    dtype, (cfg, model, params), (_, jparams, _) = rwkv
    own = model.init(torch.Generator().manual_seed(0))
    assert len(params["blocks"]) == cfg.n_layers == 2

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(params) == shapes(own)
    for layer in range(2):
        np.testing.assert_array_equal(
            params["blocks"][layer]["tm"]["wr"].float().numpy(),
            np.asarray(jparams["blocks"]["tm"]["wr"][layer], np.float32))
        np.testing.assert_array_equal(
            params["blocks"][layer]["cm"]["wk"].float().numpy(),
            np.asarray(jparams["blocks"]["cm"]["wk"][layer], np.float32))
    # a dtype cast leaves w0 and u in fp32
    cast = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU,
                             dtype=torch.bfloat16)
    tm = cast["blocks"][1]["tm"]
    assert cast["embed"].dtype == tm["wr"].dtype == torch.bfloat16
    assert cast["blocks"][0]["cm"]["mix_k"].dtype == torch.bfloat16
    assert all(tm[k].dtype == torch.float32 for k in FP32_LEAVES)


@pytest.mark.parametrize("t", [128, 9], ids=["chunked", "step"])
def test_forward_and_loss_match_the_reference(rwkv, t):
    dtype, (cfg, model, params), (_, jparams, ref) = rwkv
    rng = np.random.default_rng(2 + t)
    toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    jt, tt = both(toks)
    jl, tl = both(labels)
    want, want_aux = ref["forward"](jparams, jt)
    got, aux = model.forward(params, tt)
    assert got.dtype == TDT[dtype] and float(aux) == float(want_aux) == 0.0
    close(got, want, dtype)
    close(model.loss(params, {"tokens": tt, "labels": tl}),
          ref["loss"](jparams, {"tokens": jt, "labels": jl}), dtype)


@pytest.mark.parametrize("t", [128, 9], ids=["chunked", "step"])
def test_prefill_decode_and_caches_match_the_reference(rwkv, t):
    """Prefill (the chunked WKV at T = 128, the step recurrence at T = 9),
    three decode steps, and after each every cache entry: each layer's
    WKV state and both token-shift carries, in their dtypes."""
    dtype, (cfg, model, params), (jmodel, jparams, ref) = rwkv
    rng = np.random.default_rng(t)
    toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    jt, tt = both(toks)
    jcache = jmodel.init_cache(2)
    cache = model.init_cache(2, device=CPU)
    assert cache["wkv"][0].dtype == torch.float32
    assert cache["x_tm"][0].dtype == cache["x_cm"][1].dtype == TDT[dtype]
    want, jcache = ref["prefill"](jparams, jt, jcache)
    got, cache = model.prefill(params, tt, cache)
    close(got, want, dtype)

    def caches_close():
        for layer in range(cfg.n_layers):
            for k in ("wkv", "x_tm", "x_cm"):
                close(cache[k][layer], jcache[k][layer], dtype)

    caches_close()
    for i in range(3):
        step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        js, ts = both(step)
        want, jcache = ref["decode"](jparams, js, jcache, jnp.int32(t + i))
        got, cache = model.decode_step(params, ts, cache, t + i)
        assert got.shape == (2, cfg.vocab_size)
        close(got, want, dtype)
        caches_close()


@pytest.mark.parametrize("t", [64, 10], ids=["chunked", "step"])
def test_prefill_then_decode_equals_forward(ref_weights, t):
    """fp32: a prefill of T tokens then four decode steps give the last
    positions' logits of `forward` over the T + 4 tokens: the WKV state
    and both token shifts carry across calls (T + 4 = 68 takes the step
    recurrence in `forward`, so at T = 64 the chunked WKV is held against
    it)."""
    cfg, _ = reduced("float32")
    model = build_model(cfg)
    params = params_from_numpy(ref_weights, CPU)
    rng = np.random.default_rng(40 + t)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, t + 4)))
    cache = model.init_cache(2, device=CPU)
    logits, cache = model.prefill(params, toks[:, :t], cache)
    got = [logits]
    for i in range(4):
        logits, cache = model.decode_step(params, toks[:, t + i:t + i + 1],
                                          cache, t + i)
        got.append(logits)
    full, _ = model.forward(params, toks)
    close(torch.stack(got, dim=1), full[:, t - 1:].numpy())


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def rwkv_fp32(ref_weights):
    cfg, jcfg = reduced("float32")
    return ((cfg, build_model(cfg), params_from_numpy(ref_weights, CPU)),
            (jcfg, jax_build_model(jcfg),
             jax.tree.map(jnp.asarray, ref_weights)))


def test_fixed_batch_engine_tokens_equal_the_reference(rwkv_fp32):
    """Greedy completions of a left-padded mixed-length batch: RWKV is
    not pad-aware in either package, so the pads run through the
    recurrence in both and the tokens still agree."""
    (cfg, model, params), (jcfg, jmodel, jparams) = rwkv_fp32
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


def test_continuous_scheduler_refuses_rwkv_as_the_reference(rwkv_fp32):
    (cfg, model, params), (jcfg, jmodel, jparams) = rwkv_fp32
    with pytest.raises(ValueError) as want:
        JaxContinuousScheduler(jcfg, jmodel, jparams)
    with pytest.raises(ValueError) as got:
        ContinuousScheduler(cfg, model, params, device=CPU)
    assert str(got.value) == str(want.value)
    assert "per-slot position" in str(got.value)


def test_serve_cli_runs_rwkv_on_the_cpu(tmp_path):
    out = blocked_cli(["serve", "--arch", "rwkv6_1b6", "--reduced",
                       "--torch-device", "cpu", "--requests", "4",
                       "--max-new", "3"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "4 completions, 12 tokens" in out.stdout
    assert "tok/s on cpu" in out.stdout
    refused = blocked_cli(["serve", "--arch", "rwkv6_1b6", "--reduced",
                           "--torch-device", "cpu", "--arrivals",
                           "poisson", "--requests", "4"], tmp_path)
    assert refused.returncode == 2
    assert "per-slot position" in refused.stderr
    assert "served" not in refused.stdout
