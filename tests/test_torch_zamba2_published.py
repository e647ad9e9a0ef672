"""Zamba2 as published (`repro_torch.models.zamba2_published`) on the CPU,
against the benchmark's plain reference (`portbench/reference/zamba2.py`)
and, where `transformers` is installed, against its `Zamba2ForCausalLM`.

The model is the tiny variant of zamba2-7b-instruct (`reduced()`): d =
64, four heads of 32 over the 128-wide concat[x, x0], two groups of B
and C, two alternating shared blocks, adapters of rank 8, seven layers
of which 1, 3 and 4 are hybrid.  Tolerances are relative to the
reference's largest |logit|: fp32 1e-4 (the same equations summed in
another order: the port's scan in chunks of 64, the reference's in
chunks of 8, the conv as taps against `conv1d`); bf16 0.1 (every weight,
activation and product rounded to bf16 over seven layers reads 4e-2 at
this size, and the reference's fp8 control 0.47).  Also here: the
published layout's widths, the registry's separate table, the spans and
counts, `serve --arch zamba2-7b-instruct`, and `attention_scores` and
`flash_full` bit for bit as they were without `scale=`.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import zamba2 as ref  # noqa: E402

from repro_torch.configs.zamba2_7b_instruct import HF_CONFIG  # noqa: E402
from repro_torch.models import ARCH_IDS, build_model, get_config  # noqa: E402
from repro_torch.models import flash, layers  # noqa: E402
from repro_torch.models.registry import PUBLISHED_IDS  # noqa: E402
from repro_torch.models.zamba2_published import (  # noqa: E402
    Zamba2Layout, Zamba2PublishedModel)
from repro_torch.serving import Request, ServingEngine  # noqa: E402

CPU = "cpu"
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def tiny(dtype="float32") -> Zamba2Layout:
    return dataclasses.replace(get_config("zamba2-7b-instruct").reduced(),
                               dtype=dtype)


def keys(cfg: Zamba2Layout, chunk: int = 8) -> dict:
    """The layout under the published config's keys, as the reference
    reads them."""
    kinds = ["hybrid" if i in cfg.hybrid_layer_ids else "mamba"
             for i in range(cfg.num_hidden_layers)]
    return dict(HF_CONFIG, vocab_size=cfg.vocab_size,
                hidden_size=cfg.hidden_size,
                num_hidden_layers=cfg.num_hidden_layers,
                layers_block_type=kinds,
                hybrid_layer_ids=list(cfg.hybrid_layer_ids),
                num_attention_heads=cfg.num_attention_heads,
                num_key_value_heads=cfg.num_attention_heads,
                attention_head_dim=cfg.attention_head_dim,
                attention_hidden_size=cfg.attention_hidden_size,
                kv_channels=cfg.hidden_size // cfg.num_attention_heads,
                intermediate_size=cfg.intermediate_size,
                ffn_hidden_size=cfg.intermediate_size,
                adapter_rank=cfg.adapter_rank,
                mamba_d_state=cfg.mamba_d_state,
                mamba_headdim=cfg.mamba_headdim,
                n_mamba_heads=cfg.n_mamba_heads, chunk_size=chunk)


def built(dtype="float32", seed=0):
    cfg = tiny(dtype)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    return cfg, model, model.init(gen), gen


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


# ------------------------------------------------------------ the layout
def test_the_published_layout():
    cfg = get_config("zamba2-7b-instruct")
    assert get_config("zamba2_7b_instruct") is cfg
    assert cfg.param_count() == 7_356_749_648
    assert (cfg.attention_hidden_size, cfg.attention_head_dim,
            cfg.num_attention_heads) == (7168, 224, 32)
    assert cfg.attention_scale == 112 ** -0.5
    assert (cfg.d_inner, cfg.conv_dim, cfg.in_proj_width) == \
        (7168, 7424, 7168 + 7424 + 112)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77)
    assert Zamba2Layout.from_hf(dict(
        HF_CONFIG, layers_block_type=[
            "hybrid" if i in cfg.hybrid_layer_ids else "mamba"
            for i in range(81)]), name=cfg.name) == cfg


@pytest.mark.parametrize("change", [
    {"use_shared_attention_adapter": True}, {"time_step_limit": [0, 1]},
    {"hidden_act": "silu"}, {"use_long_context": True},
    {"num_key_value_heads": 8}, {"kv_channels": 224},
    {"layers_block_type": ["mamba"] * 81}, {"mamba_ngroups": 3}])
def test_the_layout_refuses_what_it_does_not_implement(change):
    with pytest.raises(ValueError):
        Zamba2Layout.from_hf(dict(HF_CONFIG, **change))


def test_the_registry_keeps_the_published_variant_apart():
    assert PUBLISHED_IDS == ["zamba2_7b_instruct"]
    assert not set(PUBLISHED_IDS) & set(ARCH_IDS)
    assert isinstance(build_model(get_config("zamba2-7b-instruct")),
                      Zamba2PublishedModel)


# ----------------------------------------------------- against the reference
@pytest.mark.parametrize("dtype,t", [("float32", 21), ("float32", 150),
                                     ("bfloat16", 21)])
def test_forward_and_prefill_match_the_reference(dtype, t):
    """T = 150 takes three of the port's scan chunks and 19 of the
    reference's."""
    cfg, model, params, gen = built(dtype)
    tokens = torch.randint(0, cfg.vocab_size, (2, t), generator=gen)
    want = ref.logits(params, keys(cfg), tokens, positions=range(t))
    logits, aux = model.forward(params, tokens)
    assert float(aux) == 0.0
    assert rel(logits, want) <= TOL[dtype]
    cache = model.init_cache(2, t, device=CPU)
    last, _ = model.prefill(params, tokens, cache)
    assert rel(last, want[:, -1]) <= TOL[dtype]


def test_prefill_then_decode_matches_the_reference_forward():
    cfg, model, params, gen = built()
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    cache = model.init_cache(2, 16, device=CPU)
    outs = [model.prefill(params, tokens[:, :12], cache)[0]]
    for pos in range(12, 16):
        outs.append(model.decode_step(params, tokens[:, pos:pos + 1], cache,
                                      pos)[0])
    want = ref.logits(params, keys(cfg), tokens, positions=range(11, 16))
    for k, out in enumerate(outs):
        assert rel(out, want[:, k]) <= TOL["float32"], k


def test_the_prefill_fills_every_cache():
    cfg, model, params, gen = built()
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    cache = model.init_cache(2, 12, device=CPU)
    model.prefill(params, tokens, cache)
    assert len(cache["k"]) == cfg.n_hybrid
    assert len(cache["ssm"]) == cfg.num_hidden_layers
    for k in cache["k"]:
        assert tuple(k.shape) == (2, 12, 4, 32)
        assert bool(k[:, :9].abs().sum(-1).gt(0).all())
        assert torch.equal(k[:, 9:], torch.zeros_like(k[:, 9:]))
    for s, c in zip(cache["ssm"], cache["conv"]):
        assert s.dtype == torch.float32 and tuple(s.shape) == (2, 8, 16, 16)
        assert tuple(c.shape) == (2, 3, cfg.conv_dim)
        assert bool(s.abs().sum() > 0)


@pytest.mark.parametrize("t,chunk", [(21, 8), (16, 8), (5, 8), (40, 16)])
def test_the_reference_chunked_ssd_is_the_step_recurrence(t, chunk):
    gen = torch.Generator().manual_seed(t)
    h, p, n = 3, 4, 5
    x = torch.randn(t, h, p, generator=gen)
    dt = torch.rand(t, h, generator=gen) * 0.5 + 0.01
    a = -torch.rand(h, generator=gen) - 0.2
    bm, cm = torch.randn(t, n, generator=gen), torch.randn(t, n,
                                                           generator=gen)
    y, final = ref.ssd(x, dt, a, bm, cm, chunk, ref._Ops(ref.EXACT))
    state = torch.zeros(h, p, n)
    for i in range(t):
        state = torch.exp(dt[i] * a)[:, None, None] * state + \
            dt[i][:, None, None] * x[i][:, :, None] * bm[i][None, None]
        assert torch.allclose(y[i], state @ cm[i], atol=1e-5, rtol=1e-5), i
    assert torch.allclose(final, state, atol=1e-5, rtol=1e-5)


def _hf_model(cfg: Zamba2Layout, params):
    """transformers' Zamba2ForCausalLM on the tiny layout, in fp32 with
    eager attention, its weights set from the port's.  Its eager mixer
    departs from the published CUDA path twice, and this test keeps both
    out of play: it clamps dt below at `time_step_min` (1e-9 here, so the
    clamp does not bind), and it sums the states passed between chunks
    over the receiving chunk's axis, not the sending one, so its
    `chunk_size` here (32) holds the whole sequence in one chunk; the
    reference's own chunks are held to the step recurrence above."""
    from transformers import Zamba2Config, Zamba2ForCausalLM

    hc = Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers,
        layers_block_type=keys(cfg)["layers_block_type"],
        mamba_d_state=cfg.mamba_d_state, mamba_d_conv=cfg.mamba_d_conv,
        mamba_expand=cfg.mamba_expand, mamba_ngroups=cfg.mamba_ngroups,
        n_mamba_heads=cfg.n_mamba_heads, time_step_min=1e-9,
        time_step_floor=1e-9, chunk_size=32, use_conv_bias=True,
        add_bias_linear=False, intermediate_size=cfg.intermediate_size,
        hidden_act="gelu", num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_attention_heads,
        num_mem_blocks=cfg.num_mem_blocks,
        use_shared_attention_adapter=False, adapter_rank=cfg.adapter_rank,
        use_mem_rope=True, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_norm_eps, tie_word_embeddings=True,
        attn_implementation="eager")
    model = Zamba2ForCausalLM(hc).eval()
    wide = cfg.attention_hidden_size

    def put(param, value):
        with torch.no_grad():
            param.copy_(value.float())

    m = model.model
    put(m.embed_tokens.weight, params["embed"])
    put(model.lm_head.weight, params["embed"])
    put(m.final_layernorm.weight, params["final_norm"])
    for layer, p in enumerate(params["layers"]):
        j = cfg.hybrid_layer_ids.index(layer) \
            if layer in cfg.hybrid_layer_ids else None
        mod = m.layers[layer]
        mamba = mod.mamba_decoder if j is not None else mod
        put(mamba.input_layernorm.weight, p["norm"])
        mx = mamba.mamba
        put(mx.in_proj.weight, p["w_in"].T)
        put(mx.conv1d.weight, p["conv_w"].T[:, None, :])
        put(mx.conv1d.bias, p["conv_b"])
        for name in ("dt_bias", "A_log", "D"):
            put(getattr(mx, name), p[name])
        put(mx.norm.weight, p["norm_gate"])
        put(mx.out_proj.weight, p["w_out"].T)
        if j is None:
            continue
        blk, hyb = params["blocks"][j % cfg.num_mem_blocks], \
            params["hybrid"][j]
        put(mod.linear.weight, hyb["linear"].T)
        st = mod.shared_transformer
        assert st.block_id == j % cfg.num_mem_blocks
        put(st.input_layernorm.weight, blk["in_norm"])
        for i, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            put(getattr(st.self_attn, proj).weight,
                blk["w_qkv"][:, i * wide:(i + 1) * wide].T)
        put(st.self_attn.o_proj.weight, blk["wo"].T)
        put(st.pre_ff_layernorm.weight, blk["ff_norm"])
        ff = st.feed_forward
        put(ff.gate_up_proj.weight, blk["w_gate_up"].T)
        put(ff.down_proj.weight, blk["w_down"].T)
        put(ff.gate_up_proj_adapter_list[j][0].weight, hyb["lora_a"].T)
        put(ff.gate_up_proj_adapter_list[j][1].weight, hyb["lora_b"].T)
    return model


def test_the_reference_is_transformers_zamba2():
    pytest.importorskip("transformers")
    cfg, _, params, gen = built()
    tokens = torch.randint(0, cfg.vocab_size, (2, 19), generator=gen)
    with torch.no_grad():
        hf = _hf_model(cfg, params)(input_ids=tokens, use_cache=False,
                                    logits_to_keep=0).logits
    want = ref.logits(params, keys(cfg), tokens, positions=range(19))
    assert rel(hf, want) <= TOL["float32"]


# --------------------------------------------------- serving and counts
def test_the_engine_keeps_the_prefill_logits_and_the_counts():
    cfg, model, params, gen = built()
    prompts = torch.randint(0, cfg.vocab_size, (3, 10), generator=gen)
    engine = ServingEngine(cfg, model, params, max_batch=3, max_len=16,
                           device=CPU)
    out = engine.run([Request(rid=i, prompt=prompts[i].numpy(),
                              max_new_tokens=1) for i in range(3)])
    want = ref.logits(params, keys(cfg), prompts)[:, 0]
    assert rel(engine.last_prefill_logits, want) <= TOL["float32"]
    assert [c.tokens for c in out] == \
        [[int(t)] for t in engine.last_prefill_logits.argmax(-1)]
    # the attention and mixer kernels launch only on a card: none on the CPU
    assert model.last_prefill_counts == {
        "ssd_calls": cfg.num_hidden_layers * cfg.mamba_ngroups,
        "shared_applications": cfg.n_hybrid, "mixer_fused": 0,
        "prefill_attention": 0}


def test_the_spans_are_traced():
    from torch.profiler import ProfilerActivity, profile

    cfg, model, params, gen = built()
    prompts = torch.randint(0, cfg.vocab_size, (1, 6), generator=gen)
    engine = ServingEngine(cfg, model, params, max_batch=1, max_len=8,
                           device=CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run([Request(rid=0, prompt=prompts[0].numpy(),
                            max_new_tokens=1)])
    names = [e.name for e in prof.events()]
    assert names.count("repro_torch.prefill") == 1
    assert names.count("repro_torch.zamba2.shared") == cfg.n_hybrid
    assert names.count("repro_torch.zamba2.mamba") == cfg.num_hidden_layers
    assert names.count("repro_torch.ssd") == \
        cfg.num_hidden_layers * cfg.mamba_ngroups


def test_serve_runs_the_published_variant(capsys):
    from repro_torch.launch.serve import serve_main

    assert serve_main(["--arch", "zamba2-7b-instruct", "--reduced",
                       "--torch-device", "cpu", "--requests", "2",
                       "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "2 completions, 6 tokens" in out


# ------------------------------------------------ the attention scale
def _scores_as_before(q, k, v, mask):
    """`layers.attention_scores` as it was before `scale=`."""
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).float() / math.sqrt(hd)
    m = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    scores = torch.where(m, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(b, t, h, hd)


def _flash_as_before(q, k, v, bq, bk):
    """`flash.flash_full` as it was before `scale=` (no window)."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, t, kv, g, hd)
    chunks = []
    for qi in range(t // bq):
        qc = qg[:, qi * bq:(qi + 1) * bq].float() * scale
        m_run = torch.full((b, kv, g, bq), -1e30)
        l_run = torch.zeros((b, kv, g, bq))
        acc = torch.zeros((b, kv, g, bq, hd))
        for ki in range(t // bk):
            kc = k[:, ki * bk:(ki + 1) * bk].float()
            vc = v[:, ki * bk:(ki + 1) * bk].float()
            scores = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc)
            qp = qi * bq + torch.arange(bq)[:, None]
            kp = ki * bk + torch.arange(bk)[None, :]
            scores = torch.where(kp <= qp, scores, -1e30)
            m_new = torch.maximum(m_run, scores.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(scores - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vc)
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        chunks.append(out.to(q.dtype))
    return torch.cat(chunks, dim=3).permute(0, 3, 1, 2, 4).reshape(
        b, t, h, hd)


def _qkv(dtype, t=16, h=4, kv=2, hd=8):
    gen = torch.Generator().manual_seed(3)
    return [torch.randn(2, t, n, hd, generator=gen).to(dtype)
            for n in (h, kv, kv)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_scale_default_is_bit_identical(dtype):
    q, k, v = _qkv(dtype)
    mask = layers._causal_mask(16, 16)
    assert torch.equal(layers.attention_scores(q, k, v, mask),
                       _scores_as_before(q, k, v, mask))
    assert torch.equal(flash.flash_full(q, k, v, bq=8, bk=4),
                       _flash_as_before(q, k, v, 8, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_scale_is_applied(dtype):
    q, k, v = _qkv(torch.float32)
    mask = layers._causal_mask(16, 16)
    # scaling q by s * sqrt(hd) under the default is scaling the scores
    s = 0.3
    want = layers.attention_scores(q * (s * math.sqrt(8)), k, v, mask)
    got = layers.attention_scores(q, k, v, mask, scale=s)
    assert torch.allclose(got, want, atol=1e-5)
    got = flash.flash_full(q.to(dtype), k.to(dtype), v.to(dtype), bq=8,
                           bk=4, scale=s)
    assert torch.allclose(got.float(), want, atol=2e-2 if dtype ==
                          torch.bfloat16 else 1e-5)
    assert not torch.allclose(got.float(), layers.attention_scores(
        q, k, v, mask), atol=1e-3)


def test_a_flash_scale_matches_softmax():
    q, k, v = _qkv(torch.float32, t=8, h=2, kv=2)
    s = 0.7
    scores = torch.einsum("bthd,bshd->bhts", q, k) * s
    scores = scores.masked_fill(~layers._causal_mask(8, 8), float("-inf"))
    want = torch.einsum("bhts,bshd->bthd", F.softmax(scores, -1), v)
    got = flash.flash_full(q, k, v, bq=4, bk=4, scale=s)
    assert np.allclose(got.numpy(), want.numpy(), atol=1e-5)
