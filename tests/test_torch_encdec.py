"""The port's Whisper encoder-decoder against the reference's, on the CPU.

`sinusoidal_positions` and `_sin_pos_dynamic`; `encode`, `cross_kv_all`,
`prefill` with 4 `decode_step`s and `loss` of reduced whisper-large-v3
(2 + 2 layers, d_model 256, its 1500 encoder positions cut to 48 by the
same `dataclasses.replace` on both packages' configs), with the
reference's weights carried over by `params_from_numpy`; the fixed-batch
engine's greedy tokens with frames against the reference engine's; and
`serve --arch whisper_large_v3 --reduced --torch-device cpu`, whose
prompts and frames are the reference serve's draws.

Tolerances, relative to the largest |reference| value: fp32 1e-5 (the
same ops summed in another order); bf16 5e-2, the reference's own bf16
tolerance.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models import get_config as jax_get_config
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

import repro_torch.launch.serve as port_serve
from repro_torch.models import (EncDecModel, build, build_model, get_config,
                                params_from_numpy)
from repro_torch.models import encdec
from repro_torch.models.layers import AttnSpec
from repro_torch.serving import Request, ServingEngine

from test_torch_support import blocked_cli

RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CPU = "cpu"
ENC_SEQ = 48


def close(got, want, dtype="float32"):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float32) - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= RTOL[dtype] * scale, f"max |err| {err:.3e} vs {scale:.3e}"


def configs(dtype="float32"):
    kw = dict(dtype=dtype, encoder_seq=ENC_SEQ)
    return (dataclasses.replace(get_config("whisper_large_v3").reduced(),
                                **kw),
            dataclasses.replace(jax_get_config("whisper_large_v3").reduced(),
                                **kw))


def _models(dtype):
    cfg, jcfg = configs(dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    ref = jax.tree.map(np.asarray, jparams)
    model = build_model(cfg)
    return cfg, model, params_from_numpy(ref, CPU), jcfg, jmodel, jparams


@pytest.fixture(scope="module")
def whisper():
    return _models("float32")


@pytest.fixture(scope="module")
def whisper_bf16():
    return _models("bfloat16")


def _inputs(cfg, b=2, t=10, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
              * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return frames, toks


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize("t0,t1,d", [(0, 48, 256), (0, 1500, 1280),
                                     (7, 19, 64)])
def test_sinusoidal_positions_are_the_references(t0, t1, d):
    """The divisors 10000^(2i/d) agree within one fp32 ulp (torch's and
    XLA's pow round apart at a few i), and position p multiplies that
    ulp into its angle: at p up to t1 the sines and cosines agree within
    4 x 2^-23 x t1 (3.6e-4 at Whisper's 1500 positions), or 1e-5."""
    got = encdec.sinusoidal_positions(t0, t1, d)
    want = np.asarray(jax_encdec.sinusoidal_positions(t0, t1, d))
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = max(1e-5, 4 * np.finfo(np.float32).eps * t1)
    assert float(np.abs(got.numpy() - want).max()) <= tol
    dim = torch.arange(0, d, 2, dtype=torch.float32)
    ulps = np.abs(torch.pow(10000.0, dim / d).numpy().view(np.int32)
                  - np.asarray(jnp.power(10000.0, jnp.arange(
                      0, d, 2, dtype=jnp.float32) / d)).view(np.int32))
    assert ulps.max() <= 1


@pytest.mark.parametrize("pos", [0, 1, 17, 447])
def test_sin_pos_dynamic_is_the_references(pos):
    want = jax_encdec._sin_pos_dynamic(jnp.int32(pos), 256)
    close(encdec._sin_pos_dynamic(pos, 256), want)
    close(encdec._sin_pos_dynamic(torch.tensor(pos), 256), want)
    # a position that is a tensor stays one: no host sync
    got = encdec._sin_pos_dynamic(torch.tensor(pos), 256)
    assert got.shape == (1, 1, 256)
    close(got[0, 0], encdec.sinusoidal_positions(pos, pos + 1, 256)[0])


def test_build_gives_the_encdec_model():
    cfg, model = build("whisper_large_v3")
    assert isinstance(model, EncDecModel)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.d_ff, cfg.vocab_size, cfg.encoder_seq) == \
        (32, 32, 1280, 20, 5120, 51866, 1500)
    assert 2.0e9 < cfg.param_count() < 2.05e9


def test_init_has_the_reference_shapes_and_dtypes(whisper):
    cfg, model, params, jcfg, jmodel, jparams = whisper
    mine = model.init(torch.Generator().manual_seed(0))
    assert len(mine["encoder"]) == cfg.encoder_layers
    assert len(mine["decoder"]) == cfg.n_layers
    for key in ("embed", "unembed", "ln_enc", "ln_dec"):
        assert tuple(mine[key].shape) == tuple(jparams[key].shape)
    for stack in ("encoder", "decoder"):
        want = jax.tree.map(lambda a: (tuple(a.shape[1:]), str(a.dtype)),
                            jparams[stack])
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]),
                           mine[stack][0])
        assert got == want


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_the_reference(whisper, whisper_bf16, dtype):
    cfg, model, params, jcfg, jmodel, jparams = \
        whisper if dtype == "float32" else whisper_bf16
    frames, _ = _inputs(cfg)
    got = model.encode(params, torch.from_numpy(frames))
    assert got.dtype == TDT[dtype]
    close(got, jmodel.encode(jparams, jnp.asarray(frames)), dtype)


def test_cross_kv_all_matches_the_reference(whisper):
    cfg, model, params, jcfg, jmodel, jparams = whisper
    frames, _ = _inputs(cfg)
    enc = model.encode(params, torch.from_numpy(frames))
    jenc = jmodel.encode(jparams, jnp.asarray(frames))
    spec = AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim)
    got = encdec.cross_kv_all([p["cross_attn"] for p in params["decoder"]],
                              enc, spec)
    jk, jv = jax_encdec.cross_kv_all(jparams["decoder"]["cross_attn"], jenc,
                                     jmodel._spec(True))
    assert len(got) == cfg.n_layers
    close(torch.stack([k for k, _ in got]), jk)
    close(torch.stack([v for _, v in got]), jv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(whisper, whisper_bf16,
                                                dtype):
    cfg, model, params, jcfg, jmodel, jparams = \
        whisper if dtype == "float32" else whisper_bf16
    frames, toks = _inputs(cfg, t=10)
    cache = model.init_cache(2, 16, device=CPU)
    jcache = jmodel.init_cache(2, 16)
    got, cache = model.prefill(params, torch.from_numpy(toks[:, :6]), cache,
                               torch.from_numpy(frames))
    want, jcache = jmodel.prefill(jparams, jnp.asarray(toks[:, :6]), jcache,
                                  jnp.asarray(frames))
    close(got, want, dtype)
    for i in range(6, 10):
        # positions as ints and as 0-d tensors, as the engine and a
        # captured step pass them
        pos = i if i % 2 else torch.tensor(i)
        got, cache = model.decode_step(params, torch.from_numpy(
            toks[:, i:i + 1]), cache, pos)
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(
            toks[:, i:i + 1]), jcache, jnp.int32(i))
        close(got, want, dtype)
    for key in ("self_k", "self_v"):
        close(torch.stack(cache[key]), jcache[key], dtype)
    close(cache["enc"], jcache["enc"], dtype)


def test_decode_equals_teacher_forcing(whisper):
    """prefill + decode steps give the logits of one teacher-forced pass
    (`encode` -> `_decoder_stack(mode="train")` -> `ln_dec` -> `unembed`)
    at the same positions, as the card's check holds at full size."""
    cfg, model, params, *_ = whisper
    frames, toks = _inputs(cfg, t=12, seed=3)
    frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)
    cache = model.init_cache(2, 12, device=CPU)
    got = [model.prefill(params, toks[:, :8], cache, frames)[0]]
    for i in range(8, 12):
        got.append(model.decode_step(params, toks[:, i:i + 1], cache, i)[0])
    from repro_torch.models.layers import rms_norm
    enc = model.encode(params, frames)
    x, _ = model._decoder_stack(params, model._dec_embed(params, toks), enc,
                                "train")
    full = rms_norm(x, params["ln_dec"], cfg.norm_eps) @ params["unembed"]
    close(torch.stack(got, dim=1), full[:, 7:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_the_reference(whisper, whisper_bf16, dtype):
    cfg, model, params, jcfg, jmodel, jparams = \
        whisper if dtype == "float32" else whisper_bf16
    frames, toks = _inputs(cfg, t=9, seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}
    got = model.loss(params, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    want = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.dtype == torch.float32
    close(got, want, dtype)


# ---------------------------------------------------------------- serving
def test_engine_tokens_with_frames_equal_the_reference(whisper):
    """Greedy completions of a mixed-length batch, one request without
    frames (the engine feeds it zeros, as the reference's does)."""
    cfg, model, params, jcfg, jmodel, jparams = whisper
    rng = np.random.default_rng(11)
    reqs, jreqs = [], []
    for i, n in enumerate((5, 9, 7)):
        prompt = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        frames = None if i == 1 else (
            rng.standard_normal((cfg.encoder_seq, cfg.d_model))
            * 0.02).astype(np.float32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=5,
                            frames=frames))
        jreqs.append(JaxRequest(rid=i, prompt=prompt, max_new_tokens=5,
                                frames=frames))
    got = ServingEngine(cfg, model, params, max_batch=2, max_len=24,
                        device=CPU).run(reqs)
    want = JaxServingEngine(jcfg, jmodel, jparams, max_batch=2,
                            max_len=24).run(jreqs)
    assert [(c.rid, c.tokens) for c in got] == \
        [(c.rid, c.tokens) for c in want]


class _Recorder:
    """A stand-in engine that records the requests it is given."""

    seen = []

    def __init__(self, *args, **kw):
        pass

    def run(self, reqs):
        type(self).seen = list(reqs)
        time.sleep(0.001)           # the caller divides by the wall
        return []


def test_serve_draws_the_reference_prompts_and_frames(monkeypatch):
    """`serve --arch whisper_large_v3 --reduced`: each request's prompt and
    frames are the reference serve's, drawn from one generator in the same
    order (frames between prompts)."""
    argv = ["--arch", "whisper_large_v3", "--reduced", "--requests", "3",
            "--max-new", "2"]

    class Mine(_Recorder):
        seen = []

    class Theirs(_Recorder):
        seen = []

    monkeypatch.setattr(port_serve, "ServingEngine", Mine)
    monkeypatch.setattr(jax_serve, "ServingEngine", Theirs)
    assert port_serve.serve_main(argv + ["--torch-device", "cpu"]) == 0
    jax_serve.serve_main(argv)
    assert len(Mine.seen) == len(Theirs.seen) == 3
    for got, want in zip(Mine.seen, Theirs.seen):
        assert np.array_equal(got.prompt, want.prompt)
        assert got.frames.dtype == want.frames.dtype == np.float32
        assert got.frames.shape == (1500, 256)
        assert np.array_equal(got.frames, want.frames)


def test_serve_cli_runs_whisper_on_the_cpu(tmp_path):
    out = blocked_cli(["serve", "--arch", "whisper_large_v3", "--reduced",
                       "--torch-device", "cpu", "--requests", "4",
                       "--max-new", "3"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "4 completions, 12 tokens" in out.stdout
    assert "tok/s on cpu" in out.stdout
    refused = blocked_cli(["serve", "--arch", "whisper_large_v3",
                           "--reduced", "--torch-device", "cpu",
                           "--arrivals", "poisson", "--requests", "4"],
                          tmp_path)
    assert refused.returncode == 2
    assert "per-slot position" in refused.stderr
