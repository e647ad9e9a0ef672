"""The port's training path against the reference's, on the CPU.

The synthetic token streams and `make_batch` bit-equal to the
reference's; `InputShape` and `shape_applicable`; AdamW on identical
numpy gradients against the reference's over 3 steps (with and without
the clip binding) and its schedule; checkpoints written by either package
read by the other (a bf16 leaf included; the manifest keys are the
reference's `_flatten` keys); `params_to_numpy(params_from_numpy(ref))
== ref` for every architecture; one train step of every architecture
(reduced, fp32): the loss and every leaf's gradient against
`jax.value_and_grad(model.loss)` (gradients, not the updated params: at
step 1 AdamW moves a weight by about lr x sign(g), so a near-zero
gradient whose sign differs across frameworks would move it by 2 lr);
longer steps past one SSD chunk and through RWKV6's chunked WKV; the
CUDA path's `ssd_chunk_scan` gradient (`ScanWithGrad`, the launch
replaced by the plain arithmetic, since no kernel runs here) against
autograd through `ssd_chunk_scan_plain`, and that version's gradients
finite under steep decays; and the `launch.train` CLI.

Tolerances: a loss within 1e-5 of the reference's (fp32); each leaf's
gradient within 1e-4 of that leaf's largest |reference gradient| (fp32
sums in another order through a backward pass; the worst leaf of every
architecture sits near 1e-5); AdamW's params within 1e-6 of their
largest |value| and its moments within 1e-6 of theirs (the same fp32
ops); the schedule within 1e-7 relative.
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.checkpoint.store import _flatten as jax_flatten
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokenStream as JaxStream
from repro.data import make_batch as jax_make_batch
from repro.launch.shapes import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.launch.shapes import shape_applicable as jax_shape_applicable
from repro.models import build_model as jax_build_model
from repro.models import get_config as jax_get_config
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_adamw as jax_init_adamw
from repro.optim.adamw import _schedule as jax_schedule

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.store import _flatten
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, SyntheticTokenStream, make_batch
from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.launch import INPUT_SHAPES, shape_applicable
from repro_torch.launch.steps import (loss_and_grads, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import (ARCH_IDS, build_model, get_config,
                                params_from_numpy, params_to_numpy,
                                params_to_reference)
from repro_torch.optim import AdamWConfig, adamw_update, init_adamw
from repro_torch.optim.adamw import _schedule

from test_torch_support import ROOT, blocked_cli

CPU = "cpu"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAMW_RTOL = 1e-6


def reduced_configs(arch, dtype="float32"):
    """The port's and the reference's reduced `arch`, in `dtype`; an
    encoder-decoder's 1500 encoder positions cut to 48 on both."""
    kw = {"dtype": dtype}
    if get_config(arch).is_encoder_decoder:
        kw["encoder_seq"] = 48
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jax_get_config(arch).reduced(), **kw))


def reference_params(jcfg, seed=0):
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,b,t,seed", [(512, 2, 16, 0),
                                            (51866, 4, 128, 3),
                                            (65536, 1, 300, 11)])
def test_token_stream_is_bit_equal_to_the_reference(vocab, b, t, seed):
    mine = iter(SyntheticTokenStream(vocab, DataConfig(b, t, seed)))
    theirs = iter(JaxStream(vocab, JaxDataConfig(b, t, seed)))
    for _ in range(3):
        got, want = next(mine), next(theirs)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["whisper_large_v3", "codeqwen15_7b"])
@pytest.mark.parametrize("seed", [0, 5])
def test_make_batch_is_bit_equal_to_the_reference(arch, seed):
    cfg, jcfg = reduced_configs(arch)
    got = make_batch(cfg, 2, 32, seed=seed)
    want = jax_make_batch(jcfg, 2, 32, seed=seed)
    assert sorted(got) == sorted(want)
    assert ("frames" in got) == cfg.is_encoder_decoder
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


# ----------------------------------------------------------------- shapes
def test_input_shapes_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_is_the_references(arch):
    for name in INPUT_SHAPES:
        assert shape_applicable(get_config(arch), INPUT_SHAPES[name]) == \
            jax_shape_applicable(jax_get_config(arch),
                                 JAX_INPUT_SHAPES[name])


# ------------------------------------------------------------------ AdamW
def _tree(rng, scale):
    """A small two-level tree of fp32 leaves."""
    return {"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "blocks": [{"w": (rng.standard_normal((5,)) * scale
                              ).astype(np.float32)},
                       {"w": (rng.standard_normal((5,)) * scale
                              ).astype(np.float32)}]}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_matches_the_reference_over_three_steps(clip):
    rng = np.random.default_rng(4)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 2.0) for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip)
    cfg, jcfg = AdamWConfig(**kw), JaxAdamWConfig(**kw)
    norms = [np.sqrt(sum(float(np.square(g).sum())
                         for g in jax.tree.leaves(gs))) for gs in grads]
    assert (min(norms) > clip) == (clip == 1.0)     # the clip binds, or not
    mine, state = _torch_tree(params), None
    state = init_adamw(mine)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_init_adamw(jparams)
    for g in grads:
        mine, state = adamw_update(cfg, mine, _torch_tree(g), state)
        jparams, jstate = jax_adamw_update(
            jcfg, jparams, jax.tree.map(jnp.asarray, g), jstate)
    assert int(state.step) == int(jstate.step) == 3
    assert state.step.dtype == torch.int32
    for got, want in ((mine, jparams), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.float32
            assert rel_err(a.numpy(), b) <= ADAMW_RTOL


def test_adamw_keeps_bf16_params_and_fp32_moments():
    rng = np.random.default_rng(5)
    params = {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(
        np.float32)).to(torch.bfloat16)}
    state = init_adamw(params)
    assert state.mu["w"].dtype == state.nu["w"].dtype == torch.float32
    grads = {"w": torch.ones((8, 4), dtype=torch.bfloat16)}
    jparams = {"w": jnp.asarray(params["w"].float().numpy(), jnp.bfloat16)}
    jstate = jax_init_adamw(jparams)
    params, state = adamw_update(AdamWConfig(lr=0.1, warmup_steps=1),
                                 params, grads, state)
    jparams, jstate = jax_adamw_update(
        JaxAdamWConfig(lr=0.1, warmup_steps=1), jparams,
        {"w": jnp.ones((8, 4), jnp.bfloat16)}, jstate)
    assert params["w"].dtype == torch.bfloat16
    assert rel_err(params["w"].float().numpy(),
                   np.asarray(jparams["w"], np.float32)) <= 1e-2


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 101, 150])
def test_schedule_is_the_references(step):
    """Warmup (steps 0-10), the cosine (10-100) and its floor at 0.1 lr
    past the end."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    got = _schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = jax_schedule(JaxAdamWConfig(**kw), jnp.int32(step))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-7 * 3e-4
    if step >= 100:
        assert float(got) == pytest.approx(3e-5, rel=1e-6)


# ------------------------------------------------------------ checkpoints
def _ckpt_tree():
    rng = np.random.default_rng(6)
    bf = rng.standard_normal((3, 4)).astype(np.float32)
    return {"params": {"decoder": {"self_attn": {
        "wq": rng.standard_normal((4, 4)).astype(np.float32)}},
        "blocks": [rng.integers(0, 9, (5,)).astype(np.int32),
                   jnp.asarray(bf, jnp.bfloat16)],
        "ln": rng.standard_normal((7,)).astype(np.float32)}}


def _as_port(tree):
    """The same tree with torch leaves (bf16 through its bits)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(one, tree)


def test_checkpoint_keys_are_the_references():
    tree = _ckpt_tree()
    assert list(_flatten(_as_port(tree))) == list(jax_flatten(tree))
    assert "__params__/__decoder__/__self_attn__/__wq__" in _flatten(tree)
    assert "__params__/__blocks__/_0_" in _flatten(tree)


def test_a_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _ckpt_tree()
    out = save_checkpoint(tmp_path, 7, _as_port(tree))
    assert out == tmp_path / "7" and latest_step(tmp_path) == 7
    manifest = json.loads((out / "manifest.json").read_text())
    assert list(manifest) == list(jax_flatten(tree))
    assert manifest["__params__/__blocks__/_1_"]["dtype"] == "bfloat16"
    back = jax_restore(tmp_path, 7, tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_a_reference_checkpoint_loads_in_the_port(tmp_path):
    tree = _ckpt_tree()
    jax_save(tmp_path, 3, tree)
    assert latest_step(tmp_path) == 3 and latest_step(tmp_path / "no") is None
    back = restore_checkpoint(tmp_path, 3, _as_port(tree))
    for got, want in zip(tree_leaves(back), tree_leaves(_as_port(tree))):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("arch", ["whisper_large_v3", "zamba2_7b"])
def test_model_checkpoints_cross_both_packages(tmp_path, arch):
    """A bf16 model's params: the port's checkpoint restores in the
    reference to its own init, and the reference's in the port."""
    cfg, jcfg = reduced_configs(arch, cfg_dtype := "bfloat16")
    assert cfg_dtype == cfg.dtype
    _, jparams, ref = reference_params(jcfg)
    params = params_from_numpy(ref, CPU)
    save_checkpoint(tmp_path / "port", 1, {"params": params_to_reference(
        params)})
    back = jax_restore(tmp_path / "port", 1, {"params": jparams})
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.dtype == b.dtype and np.array_equal(
            np.asarray(a), np.asarray(b)), back["params"], jparams))
    jax_save(tmp_path / "ref", 2, {"params": jparams})
    mine = restore_checkpoint(tmp_path / "ref", 2, {
        "params": params_to_reference(params)})
    again = params_from_numpy(mine["params"], CPU)
    for a, b in zip(tree_leaves(again), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------- layout
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_round_trip_to_the_reference_layout(arch):
    cfg, jcfg = reduced_configs(arch, jax_get_config(arch).dtype)
    _, _, ref = reference_params(jcfg)
    back = params_to_numpy(params_from_numpy(ref, CPU))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_gradients_match_the_reference(arch):
    cfg, jcfg = reduced_configs(arch)
    jmodel, jparams, ref = reference_params(jcfg)
    model = build_model(cfg)
    params = params_from_numpy(ref, CPU)
    raw = jax_make_batch(jcfg, 2, 16, seed=3)
    want_loss, want_grads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in raw.items()})
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    loss, grads = loss_and_grads(model, params, batch)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    got = params_to_numpy(grads)
    want = jax.tree.map(np.asarray, want_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    worst = max(rel_err(a, b) for a, b in zip(jax.tree.leaves(got),
                                              jax.tree.leaves(want)))
    assert worst <= GRAD_RTOL, f"{arch}: worst leaf {worst:.3e}"
    # the leaves are left as they were: no grad required, no .grad kept
    assert not any(p.requires_grad or p.grad is not None
                   for p in tree_leaves(params))
    # and the step itself: the loss it returns, params moved in place
    before = [p.clone() for p in tree_leaves(params)]
    step = make_train_step(model, AdamWConfig(warmup_steps=1))
    params2, state, loss2 = step(params, init_adamw(params), batch)
    assert params2 is params and int(state.step) == 1
    assert float(loss2) == float(loss)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)))


@pytest.mark.parametrize("arch,t", [("zamba2_7b", 96), ("rwkv6_1b6", 128)])
def test_longer_train_steps_match_the_reference(arch, t):
    """Past one SSD chunk (64 tokens, a ragged last one at 96) and through
    RWKV6's chunked WKV: the gradients still match the reference's, whose
    Mamba2 takes its per-step scan below 256 tokens."""
    cfg, jcfg = reduced_configs(arch)
    jmodel, jparams, ref = reference_params(jcfg)
    raw = jax_make_batch(jcfg, 2, t, seed=3)
    want_loss, want_grads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in raw.items()})
    loss, grads = loss_and_grads(build_model(cfg), params_from_numpy(
        ref, CPU), {k: torch.from_numpy(v) for k, v in raw.items()})
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    worst = max(rel_err(a, b) for a, b in zip(
        jax.tree.leaves(params_to_numpy(grads)), jax.tree.leaves(
            jax.tree.map(np.asarray, want_grads))))
    assert worst <= GRAD_RTOL, f"{arch}: worst leaf {worst:.3e}"


def test_zamba_gradients_stay_finite_over_a_whole_reference_chunk():
    """At 256 tokens the reference's Mamba2 takes its chunked SSD, which
    masks exp(l_t - l_j) after the exp: above the diagonal the exponent
    overflows and its gradient is NaN there (a reference caveat).  The
    port's plain scan masks the exponent first: the same loss, and every
    gradient finite."""
    cfg, jcfg = reduced_configs("zamba2_7b")
    jmodel, jparams, ref = reference_params(jcfg)
    raw = jax_make_batch(jcfg, 2, 256, seed=3)
    want_loss = jmodel.loss(jparams, {k: jnp.asarray(v)
                                      for k, v in raw.items()})
    loss, grads = loss_and_grads(build_model(cfg), params_from_numpy(
        ref, CPU), {k: torch.from_numpy(v) for k, v in raw.items()})
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_serving_steps_call_the_model():
    cfg, jcfg = reduced_configs("whisper_large_v3")
    _, _, ref = reference_params(jcfg)
    model, params = build_model(cfg), params_from_numpy(ref, CPU)
    frames = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
    toks = torch.ones((1, 4), dtype=torch.long)
    cache = model.init_cache(1, 8, device=CPU)
    logits, cache = make_prefill_step(model, cfg)(params, toks, cache,
                                                  frames)
    want, _ = model.prefill(params, toks, model.init_cache(1, 8, device=CPU),
                            frames)
    assert torch.equal(logits, want)
    logits, _ = make_decode_step(model)(params, toks[:, :1], cache, 4)
    assert logits.shape == (1, cfg.vocab_size)
    dense, _ = reduced_configs("codeqwen15_7b")
    dmodel = build_model(dense)
    dparams = dmodel.init(torch.Generator().manual_seed(0))
    out, _ = make_prefill_step(dmodel, dense)(
        dparams, toks, dmodel.init_cache(1, 8, device=CPU))
    assert out.shape == (1, dense.vocab_size)


# ----------------------------------------------------- SSD scan gradient
def _ssd_operands(seed, b=2, t=70, h=3, hd=8, n=5):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, h, hd, generator=g),
            torch.randn(b, t, n, generator=g),
            torch.randn(b, t, n, generator=g),
            torch.rand(b, t, h, generator=g) * 0.5,
            -torch.rand(h, generator=g) - 0.1,
            torch.randn(b, h, hd, n, generator=g)]


@pytest.mark.parametrize("wants", [(True,) * 6,
                                   (True, True, True, True, False, False)],
                         ids=["all", "no-a-no-state"])
def test_scan_with_grad_matches_autograd_through_the_plain_scan(
        monkeypatch, wants):
    """`ScanWithGrad` (the CUDA branch's autograd Function) with its launch
    replaced by the plain arithmetic at the kernels' chunk: the forward
    gives the launch's outputs, and the backward every operand's gradient
    as autograd through `ssd_chunk_scan_plain` gives it (the same ops, so
    bit-equal)."""
    def plain_launch(plan, operands, y, sf):
        s, out = ssd_chunk.ssd_chunk_scan_plain(*operands,
                                                chunk=ssd_chunk.CHUNK)
        y.copy_(out)
        sf.copy_(s)

    monkeypatch.setattr(ssd_chunk, "launch_uncounted", plain_launch)
    monkeypatch.setattr(ssd_chunk, "plan_call", lambda *a, **k: None)
    ops = _ssd_operands(1)
    mine = [u.clone().requires_grad_(w) for u, w in zip(ops, wants)]
    sf, y = ssd_chunk.ScanWithGrad.apply(None, ssd_chunk.CHUNK, *mine)
    theirs = [u.clone().requires_grad_(w) for u, w in zip(ops, wants)]
    sf2, y2 = ssd_chunk.ssd_chunk_scan_plain(*theirs, chunk=ssd_chunk.CHUNK)
    assert torch.equal(sf, sf2) and torch.equal(y, y2)
    wy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    (torch.sum(y * wy) + sf.square().sum()).backward()
    (torch.sum(y2 * wy) + sf2.square().sum()).backward()
    for a, b, w in zip(mine, theirs, wants):
        assert (a.grad is None) == (not w)
        if w:
            assert torch.equal(a.grad, b.grad)


def test_plain_scan_gradients_are_finite_under_steep_decays():
    """dt x |a| summed over a chunk far past fp32's exp range: the forward
    is finite, and so is every gradient (the intra-chunk exponent is
    masked before its exp)."""
    ops = _ssd_operands(3, t=128)
    ops[3] = ops[3] + 4.0                  # dt ~ 4 to 4.5 ...
    ops[4] = ops[4] * 4.0                  # ... times |a| up to 4.4
    mine = [u.clone().requires_grad_(True) for u in ops]
    sf, y = ssd_chunk.ssd_chunk_scan_plain(*mine)
    (y.sum() + sf.sum()).backward()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sf).all())
    assert all(bool(torch.isfinite(u.grad).all()) for u in mine)
    # the forward is the recurrence's
    from repro_torch.kernels.ssd_chunk.ref import ssd_scan_ref
    s_ref, y_ref = ssd_scan_ref(*ops)
    assert torch.allclose(y, y_ref, rtol=1e-4, atol=1e-5 * float(
        y_ref.abs().max()))


def test_the_cpu_scan_saves_nothing_without_grad():
    """On the CPU the wrapper is the plain version; a call with no operand
    requiring grad builds no graph, on the card too (the wrapper takes
    `ScanWithGrad` only when some operand requires grad)."""
    ops = _ssd_operands(2, t=8)
    sf, y = ssd_chunk.ssd_chunk_scan(*ops)
    assert y.grad_fn is None and sf.grad_fn is None
    with torch.no_grad():
        ops[0].requires_grad_(True)
        sf, y = ssd_chunk.ssd_chunk_scan(*ops)
    assert y.grad_fn is None


# -------------------------------------------------------------------- CLI
_BLOCKED_TRAIN = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
"""


def blocked_train(args, cwd):
    """`python -m repro_torch.launch.train ARGS` with jax and `repro` kept
    from import, on one intra-op thread: the run is small, and a thread
    pool as wide as the host, beside the other test workers' pools, is
    what makes it slow."""
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED_TRAIN, *args], capture_output=True,
        text=True, cwd=cwd, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})


def test_train_cli_lowers_the_loss_on_the_cpu(tmp_path):
    out = blocked_train(["--arch", "rwkv6_1b6", "--reduced", "--steps",
                         "20", "--batch", "4", "--seq", "64",
                         "--log-every", "5", "--torch-device", "cpu",
                         "--checkpoint-dir", "ckpt"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("step ") for line in lines) == 5
    final = [line for line in lines if line.startswith("final loss")]
    assert len(final) == 1
    got, initial = (float(v) for v in final[0].replace("(", " ").replace(
        ")", " ").split()[2::2])
    assert got < initial
    assert (tmp_path / "ckpt" / "20" / "manifest.json").exists()
    # the checkpoint holds the reference's layout: it restores there
    cfg, jcfg = reduced_configs("rwkv6_1b6", jax_get_config(
        "rwkv6_1b6").dtype)
    _, jparams, _ = reference_params(jcfg)
    back = jax_restore(tmp_path / "ckpt", 20, {"params": jparams})
    assert jax.tree.structure(back) == jax.tree.structure(
        {"params": jparams})


def test_train_cli_refuses_without_cuda_and_the_mesh(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: train would run there")
    out = blocked_cli(["train", "--arch", "rwkv6_1b6", "--reduced",
                       "--steps", "2"], tmp_path)
    assert out.returncode == 2 and "CUDA is not available" in out.stderr
    assert "final loss" not in out.stdout
    mesh = blocked_train(["--arch", "rwkv6_1b6", "--reduced",
                          "--production-mesh", "--torch-device", "cpu"],
                         tmp_path)
    assert mesh.returncode == 2
    assert ("the data x model mesh needs 16 x 16 = 256 devices; this "
            "process runs on 1") in mesh.stderr
    assert "final loss" not in mesh.stdout


def test_train_main_on_the_host_mesh_is_train_bit_for_bit(monkeypatch):
    """`train_main` on the (1, 1) CPU mesh (params placed by
    `shard_params`) gives the losses `train()` gives without a mesh."""
    from repro_torch.launch import train as train_mod

    got, train = [], train_mod.train

    def spy(*args, **kwargs):
        out = train(*args, **kwargs)
        got.append(out[2])
        return out

    monkeypatch.setattr(train_mod, "train", spy)
    assert train_mod.train_main(["--arch", "deepseek_v2_lite", "--reduced",
                                 "--steps", "6", "--batch", "2", "--seq",
                                 "16", "--torch-device", "cpu",
                                 "--log-every", "5"]) == 0
    cfg = get_config("deepseek_v2_lite").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    _, _, want, _ = train(cfg, model, params, steps=6, batch=2, seq=16,
                          lr=3e-4, device="cpu")
    assert got == [want]
