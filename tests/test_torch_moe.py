"""The port's Mixture-of-Experts layer and MoE transformers against the
reference's, on the CPU.

`moe_layer` on a config whose capacity binds (8 experts, top-2, 64
tokens: capacity 20 against a mean load of 16), so dispatch drops (token,
slot) pairs: the output, the aux loss, the expert choices and the keep
mask as the reference computes them; a tie between router probabilities
(the lower expert index wins, as `jax.lax.top_k` gives it); `init_moe`'s
tree (the router fp32 in a bf16 model).  Then `TransformerModel` on
reduced deepseek-v2-lite-16b (MLA attention, a dense first layer, MoE
after it) and reduced llama4-scout (GQA attention, MoE on every layer):
forward, loss and aux, prefill and decode with their caches, in fp32 and
bf16; the init tree; `pad_aware` / `per_slot_pos` and their errors; the
fixed-batch engine's greedy tokens against the reference engine's; the
continuous scheduler refusing deepseek and serving llama4-scout; and the
serve CLI on both, with jax and `repro` blocked.

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
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serving import ContinuousScheduler as JaxContinuousScheduler
from repro.serving import Request as JaxRequest
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.models import (TransformerModel, build, build_model,
                                get_config, moe, params_from_numpy)
from repro_torch.models.layers import mlp
from repro_torch.serving import (ContinuousScheduler, Request,
                                 SchedulerConfig, ServingEngine)

from test_torch_mla import block_params
from test_torch_models import JDT, TDT, both, close, normal
from test_torch_support import blocked_cli

CPU = "cpu"


def binding_config(dtype="float32"):
    """8 experts, top-2, one shared expert, at narrow widths."""
    cfg = dataclasses.replace(
        get_config("deepseek_v2_lite").reduced(d_model=64), n_experts=8,
        experts_per_token=2, n_shared_experts=1, moe_d_ff=32, dtype=dtype)
    return cfg, JaxModelConfig(**dataclasses.asdict(cfg))


def reference_routing(jp, jx, jcfg, capacity):
    """The reference `_moe_core`'s expert choice and keep mask, by its own
    ops (it returns neither)."""
    xt = jx.reshape(-1, jx.shape[-1])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, expert_idx = jax.lax.top_k(probs, jcfg.experts_per_token)
    flat_oh = jax.nn.one_hot(expert_idx, jcfg.n_experts,
                             dtype=jnp.float32).reshape(-1, jcfg.n_experts)
    pos = jnp.einsum("me,me->m", jnp.cumsum(flat_oh, axis=0) - flat_oh,
                     flat_oh).reshape(expert_idx.shape).astype(jnp.int32)
    return np.asarray(expert_idx), np.asarray(pos), np.asarray(pos < capacity)


# ------------------------------------------------------------------- layer
def test_expert_capacity_is_the_reference_formula():
    cfg, _ = binding_config()
    for n in (1, 3, 4, 64, 1000):
        assert moe.expert_capacity(n, cfg) == max(1, int(1.25 * n * 2 / 8))
    assert moe.expert_capacity(64, cfg, 2.0) == 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_drops_and_matches_the_reference(dtype):
    cfg, jcfg = binding_config(dtype)
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg, JDT[dtype])
    tp = block_params(jp)
    rng = np.random.default_rng(5)
    jx, tx = both(normal(rng, 2, 32, cfg.d_model), dtype)
    cap = moe.expert_capacity(64, cfg)
    assert cap == 20
    y, aux = moe.moe_layer(tp, tx, cfg)
    jy, jaux = jax_moe.moe_layer(jp, jx, jcfg)
    assert y.dtype == TDT[dtype] and aux.dtype == torch.float32
    close(y, jy, dtype)
    close(aux, jaux, "float32")               # fp32 router in both
    idx, pos, keep = reference_routing(jp, jx, jcfg, cap)
    *_, t_idx, t_pos, t_keep = moe.route(tp, tx.reshape(64, -1), cfg, cap)
    assert np.array_equal(t_idx.numpy(), idx)
    assert np.array_equal(t_pos.numpy(), pos)
    assert np.array_equal(t_keep.numpy(), keep)
    assert not keep.all(), "capacity must bind on this config"


def test_a_fully_dropped_token_gets_only_the_shared_expert():
    cfg, jcfg = binding_config()
    jp = jax_moe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = block_params(jp)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(normal(rng, 1, 64, cfg.d_model))
    cap = moe.expert_capacity(64, cfg, 0.25)
    assert cap == 4
    *_, keep = moe.route(tp, x[0], cfg, cap)
    dropped = (~keep).all(-1).nonzero()[:, 0]
    assert len(dropped), "some token must lose both of its slots"
    y, _ = moe.moe_layer(tp, x, cfg, capacity_factor=0.25)
    shared = mlp(tp["shared"], x[0])
    assert torch.allclose(y[0, dropped], shared[dropped], atol=1e-6)
    assert not torch.allclose(y[0, keep.any(-1)], shared[keep.any(-1)],
                              atol=1e-3)
    jy, _ = jax_moe.moe_layer(jp, jnp.asarray(x.numpy()), jcfg, 0.25)
    close(y, jy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_router_probabilities_pick_the_lower_expert(dtype):
    """Experts 1, 3 and 6 share one router column (and 0 and 5 another),
    so their probabilities tie exactly: both packages pick the lower
    index, and the layer's outputs agree."""
    cfg, jcfg = binding_config(dtype)
    jp = dict(jax_moe.init_moe(jax.random.PRNGKey(2), jcfg, JDT[dtype]))
    router = np.asarray(jp["router"]).copy()
    router[:, 1] *= 3.0                      # make the tied three the top
    router[:, 3] = router[:, 6] = router[:, 1]
    router[:, 5] = router[:, 0]
    jp["router"] = jnp.asarray(router)
    tp = block_params(jp)
    rng = np.random.default_rng(7)
    x = normal(rng, 1, 16, cfg.d_model)
    x = np.abs(x) * np.sign(router[:, 1])    # every token favours expert 1
    jx, tx = both(x, dtype)
    idx, _, _ = reference_routing(jp, jx, jcfg, 1000)
    *_, t_idx, _, _ = moe.route(tp, tx.reshape(16, -1), cfg, 1000)
    assert np.array_equal(t_idx.numpy(), idx)
    assert (idx == [1, 3]).all()             # the tie goes to 1 and 3
    y, _ = moe.moe_layer(tp, tx, cfg)
    close(y, jax_moe.moe_layer(jp, jx, jcfg)[0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_has_the_reference_tree(dtype):
    cfg, jcfg = binding_config(dtype)
    want = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg, JDT[dtype])
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, TDT[dtype])
    assert sorted(got) == sorted(want)
    assert sorted(got["shared"]) == sorted(want["shared"])
    assert got["router"].dtype == torch.float32
    assert tuple(got["shared"]["w_gate"].shape) == (cfg.d_model, 32)
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == (torch.float32 if k == "router"
                                else TDT[dtype]), k
    # params_from_numpy keeps the router in fp32 at any dtype
    assert block_params(want)["router"].dtype == torch.float32
    cast = block_params(want, torch.bfloat16)
    assert cast["router"].dtype == torch.float32
    assert cast["shared"]["w_up"].dtype == torch.bfloat16


# ------------------------------------------------------------------- model
ARCHS = ["deepseek_v2_lite", "llama4_scout"]


@pytest.fixture(scope="module")
def models():
    """Each reduced MoE model in both packages, fp32 and bf16, with the
    reference's weights."""
    out = {}
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype=dtype)
            jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
            jm = jax_build_model(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
            out[arch, dtype] = (cfg, build_model(cfg), tp, jm, jp)
    return out


def test_build_gives_both_moe_transformers():
    for arch, attn in (("deepseek_v2_lite", "mla"), ("llama4_scout", "gqa")):
        cfg, model = build(arch)
        assert isinstance(model, TransformerModel) and cfg.is_moe
        assert {k.attn for k in model.prologue + model.pattern} == {attn}
        assert "moe" in {k.ffn for k in model.pattern}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_aux(models, arch, dtype):
    cfg, m, tp, jm, jp = models[arch, dtype]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    logits, aux = m.forward(tp, torch.from_numpy(toks))
    jlogits, jaux = jm.forward(jp, jnp.asarray(toks))
    assert logits.dtype == TDT[dtype] and float(aux) > 0.0
    close(logits, jlogits, dtype)
    close(aux, jaux, "float32" if dtype == "float32" else dtype)
    loss = m.loss(tp, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    close(loss, jm.loss(jp, {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)}), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_and_caches(models, arch, dtype):
    """A prefill then four decode steps at a shared position (and, for the
    GQA stack, a left-padded prefill and two steps at per-slot
    positions): logits and caches as the reference's."""
    cfg, m, tp, jm, jp = models[arch, dtype]
    rng = np.random.default_rng(9)
    b, t, s = 3, 9, 24
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pad = {}
    jpad = {}
    if m.pad_aware:
        jpad["start"], pad["start"] = both(np.array([0, 3, 6], np.int32))
    cache = m.init_cache(b, s, device=CPU)
    jcache = jm.init_cache(b, s)
    logits, cache = m.prefill(tp, torch.from_numpy(toks), cache, **pad)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(toks), jcache, **jpad)
    close(logits, jlogits, dtype)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        if step < 2 or not m.per_slot_pos:
            pos, jpos = t + step, jnp.int32(t + step)
        else:
            jpos, pos = both(np.array([t + step, t + step + 3, t + step + 1],
                                      np.int32))
        logits, cache = m.decode_step(tp, torch.from_numpy(tok), cache, pos,
                                      **pad)
        jlogits, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, jpos,
                                         **jpad)
        close(logits, jlogits, dtype)
    for i, (k, v) in enumerate(cache["prologue"]):
        close(k, jcache["prologue"][i][0], dtype)
        close(v, jcache["prologue"][i][1], dtype)
    for j, stacked in enumerate(jcache["pattern"]):
        for r, (k, v) in enumerate(cache["pattern"][j]):
            close(k, stacked[0][r], dtype)
            close(v, stacked[1][r], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_is_the_reference_spec(models, arch):
    cfg, m, tp, jm, jp = models[arch, "bfloat16"]
    got = m.init_cache(2, 16, device=CPU)
    want = jm.cache_spec(2, 16)
    assert len(got["prologue"]) == len(want["prologue"])
    for g, w in zip(got["prologue"], want["prologue"]):
        assert [tuple(x.shape) for x in g] == [x.shape for x in w]
        assert all(x.dtype == torch.bfloat16 for x in g)
    for g, w in zip(got["pattern"], want["pattern"]):
        assert len(g) == w[0].shape[0]
        assert [tuple(x.shape) for x in g[0]] == [x.shape[1:] for x in w]
    if cfg.attn_kind == "mla":
        assert tuple(got["pattern"][0][0][0].shape) == (2, 16,
                                                        cfg.kv_lora_rank)
        assert tuple(got["pattern"][0][0][1].shape) == (
            2, 16, cfg.qk_rope_head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_tree(models, arch):
    cfg, m, tp, jm, jp = models[arch, "bfloat16"]
    params = m.init(torch.Generator().manual_seed(0))

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    got, want = dict(leaves(params)), dict(leaves(tp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path.endswith("/router"):
            assert g.dtype == torch.float32
        if w.numel() > 1000:
            assert abs(float(g.float().std()) / float(w.float().std())
                       - 1) < 0.1, path


def test_pad_awareness_and_its_errors(models):
    _, ds, ds_p, jds, jds_p = models["deepseek_v2_lite", "float32"]
    _, l4, _, _, _ = models["llama4_scout", "float32"]
    assert (ds.pad_aware, ds.per_slot_pos) == (False, False)
    assert (jds.pad_aware, jds.per_slot_pos) == (False, False)
    assert (l4.pad_aware, l4.per_slot_pos) == (True, True)
    toks = torch.zeros((2, 4), dtype=torch.long)
    cache = ds.init_cache(2, 8, device=CPU)
    jcache = jds.init_cache(2, 8)
    start = np.array([0, 1], np.int32)
    with pytest.raises(ValueError) as want:
        jds.prefill(jds_p, jnp.zeros((2, 4), jnp.int32), jcache,
                    start=jnp.asarray(start))
    with pytest.raises(ValueError) as got:
        ds.prefill(ds_p, toks, cache, start=torch.from_numpy(start))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="requires pad_aware"):
        ds.decode_step(ds_p, toks[:, :1], cache, 4,
                       start=torch.from_numpy(start))
    with pytest.raises(ValueError) as want:
        jds.decode_step(jds_p, jnp.zeros((2, 1), jnp.int32), jcache,
                        jnp.array([4, 5], jnp.int32))
    with pytest.raises(ValueError) as got:
        ds.decode_step(ds_p, toks[:, :1], cache, torch.tensor([4, 5]))
    assert str(got.value) == str(want.value)


def _reqs(cfg, prompts, max_new, arrivals=None, cls=Request):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           t).astype(np.int32),
                max_new_tokens=max_new,
                arrival_s=0.0 if arrivals is None else arrivals[i])
            for i, t in enumerate(prompts)]


@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_batch_engine_tokens_equal_the_reference(models, arch):
    """Greedy completions of a left-padded mixed-length batch of three
    (deepseek is not pad-aware in either package, so its pads run through
    the latent attention in both)."""
    cfg, m, tp, jm, jp = models[arch, "float32"]
    reqs = _reqs(cfg, [5, 9, 7], 5)
    jreqs = _reqs(cfg, [5, 9, 7], 5, cls=JaxRequest)
    got = ServingEngine(cfg, m, tp, max_batch=3, max_len=24,
                        device=CPU).run(reqs)
    want = JaxServingEngine(cfg, jm, jp, max_batch=3, max_len=24).run(jreqs)
    assert [(c.rid, c.tokens) for c in got] == \
        [(c.rid, c.tokens) for c in want]


def test_the_scheduler_refuses_deepseek_and_serves_llama4(models):
    cfg, m, tp, jm, jp = models["deepseek_v2_lite", "float32"]
    with pytest.raises(ValueError) as want:
        JaxContinuousScheduler(cfg, jm, jp)
    with pytest.raises(ValueError) as got:
        ContinuousScheduler(cfg, m, tp, device=CPU)
    assert str(got.value) == str(want.value)
    cfg, m, tp, jm, jp = models["llama4_scout", "float32"]
    arrivals = [0.0, 0.0, 0.002, 0.004, 0.01]
    reqs = _reqs(cfg, [3, 7, 2, 9, 5], 4, arrivals)
    rep = ContinuousScheduler(
        cfg, m, tp, device=CPU,
        config=SchedulerConfig(max_batch=2, max_len=32)).run(reqs)
    jrep = JaxContinuousScheduler(
        cfg, jm, jp, config=JaxSchedulerConfig(max_batch=2, max_len=32)
    ).run(_reqs(cfg, [3, 7, 2, 9, 5], 4, arrivals, cls=JaxRequest))
    got = {c.rid: c.tokens for c in rep.completions}
    assert sorted(got) == [0, 1, 2, 3, 4]
    assert all(len(t) == 4 for t in got.values())
    assert got == {c.rid: c.tokens for c in jrep.completions}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_moe_models_on_the_cpu(arch, tmp_path):
    out = blocked_cli(["serve", "--arch", arch, "--reduced",
                       "--torch-device", "cpu", "--requests", "4",
                       "--max-new", "3"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "4 completions, 12 tokens" in out.stdout
    assert "tok/s on cpu" in out.stdout
    sched = blocked_cli(["serve", "--arch", arch, "--reduced",
                         "--torch-device", "cpu", "--arrivals", "poisson",
                         "--requests", "4", "--max-new", "3"], tmp_path)
    if arch == "deepseek_v2_lite":
        assert sched.returncode == 2
        assert "per-slot position" in sched.stderr
    else:
        assert sched.returncode == 0, sched.stderr
        assert "served 4 requests" in sched.stdout
