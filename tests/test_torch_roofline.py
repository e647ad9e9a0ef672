"""The port's roofline (`roofline.analysis`) and op walk
(`roofline.op_walk`) against the reference's, on the CPU.

`model_flops_estimate` is the reference's for every architecture and
input shape; `RooflineReport.to_dict` has the reference's keys; the walk
counts 2*M*K*N for one product and n times that under
`counted_range(n)`, counts c10d collectives by kind, and refuses real
tensors.  On reduced codeqwen1.5-7b and deepseek-v2-lite-16b the walk's
FLOPs of the train step and the decode step are those of the reference's
`analyze_hlo` of the same step, jitted on the CPU, within 1e-3.  One term
differs, and the train test names it: the reference rematerializes each
layer's forward in the backward (`jax.checkpoint` on its layer scan and
its flash query chunks), so its count is the port's plus a recomputed
forward; with `jax.checkpoint` made the identity in the test process the
two agree.

The loops `counted_range` collapses in a walk keep their outputs outside
one: the flash walks with `counted_range` replaced by `range` are
`torch.equal` to themselves, and the chunked WKV and the SSD plain scan,
which now write each chunk into a preallocated output, are `torch.equal`
(outputs and gradients) to their earlier form, which collected a list
of chunks (kept here verbatim as the oracle).  In a walk on fake tensors
each collapsed loop counts the FLOPs `FlopCounterMode` counts for the
loop run in full, and without a backward the same bytes.
"""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.shapes import INPUT_SHAPES as JAX_SHAPES
from repro.launch.shapes import InputShape as JaxInputShape
from repro.launch.steps import input_specs as jax_input_specs
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models import get_config as jax_get_config
from repro.roofline import analysis as jax_analysis
from repro.roofline.hlo_walk import analyze_hlo

from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.launch.dryrun import walk_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shapes import INPUT_SHAPES, InputShape
from repro_torch.models import ARCH_IDS, build_model, flash, get_config, ssm
from repro_torch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS, PEAKS,
                                  RooflineReport, build_report,
                                  collective_bytes_per_device,
                                  model_flops_estimate)
from repro_torch.roofline import op_walk
from repro_torch.core.loops import counted_range
from repro_torch.roofline.op_walk import analyze


# -------------------------------------------------------------- analysis
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_is_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert model_flops_estimate(cfg, shape) == \
            jax_analysis.model_flops_estimate(jcfg, JAX_SHAPES[name])


def test_report_has_the_references_keys_and_the_h100_peaks():
    fields = dict(arch="a", shape="train_4k", mesh="1x1", chips=1,
                  hlo_flops=2e12, hlo_bytes=6.7e10, collective_bytes=0.0,
                  collective_breakdown={}, model_flops=1e12,
                  peak_memory_bytes=1e9)
    mine = RooflineReport(**fields).to_dict()
    ref = jax_analysis.RooflineReport(**fields).to_dict()
    assert list(mine) == list(ref)
    assert mine["t_compute_s"] == 2e12 / 989e12
    assert mine["t_memory_s"] == 6.7e10 / 3.35e12
    assert mine["bottleneck"] == "memory"
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert PEAKS["sxm"]["bfloat16"] == PEAK_FLOPS
    # on a mesh of several devices the collective term is not counted
    multi = RooflineReport(**dict(fields, chips=8, collective_bytes=None))
    assert multi.t_collective is None and multi.to_dict()[
        "t_collective_s"] is None
    assert multi.bottleneck in ("compute", "memory")


def test_build_report_counts_collectives_on_one_device_only():
    cost = op_walk.CompCost(flops=1e9, bytes_=1e6)
    cost.coll["all-reduce"] = 512.0
    cfg = get_config("codeqwen15_7b")
    shape = INPUT_SHAPES["decode_32k"]
    one = build_report("codeqwen15_7b", shape, "1x1", 1, cost, 0.0, cfg)
    assert one.collective_bytes == 512.0
    assert collective_bytes_per_device(cost)["all-reduce"] == 512
    assert build_report("codeqwen15_7b", shape, "2x4", 8, cost, 0.0,
                        cfg).collective_bytes is None


# ------------------------------------------------------------------ walk
def test_the_walk_counts_one_product_and_its_trip_count():
    with FakeTensorMode():
        a, b = torch.empty(64, 256), torch.empty(256, 32)
        one = analyze(lambda: a @ b)
        assert one.flops == 2 * 64 * 256 * 32
        assert one.bytes_ == 4 * (64 * 256 + 256 * 32 + 64 * 32)
        w = torch.empty(256, 256)

        def loop(n):
            x = a
            for _ in counted_range(n):
                x = torch.tanh(x @ w)
            return x

        for n in (1, 2, 7):
            assert analyze(loop, n).flops == n * 2 * 64 * 256 * 256


def test_the_walk_counts_collectives_and_refuses_real_tensors():
    with FakeTensorMode():
        x = torch.empty(64, 32)
        cost = analyze(lambda: torch.ops._c10d_functional.wait_tensor(
            torch.ops._c10d_functional.all_reduce(x, "sum", "g0")))
    assert cost.coll["all-reduce"] == 64 * 32 * 4
    assert sum(cost.coll.values()) == cost.coll["all-reduce"]
    with pytest.raises(RuntimeError, match="real tensor"):
        analyze(lambda: torch.ones(3) @ torch.ones(3))
    # a constant made inside the fake mode is lifted, not refused
    with FakeTensorMode():
        y = torch.empty(4, 4)
        assert analyze(lambda: y * torch.tensor(2.0)).bytes_ > 0


# --------------------------------------- the walk against the reference
def _reference_cost(arch, kind, b, t):
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    specs = jax_input_specs(jcfg, jmodel, JaxInputShape("x", t, b, kind))
    if kind == "train":
        lowered = jax.jit(jax_make_train_step(jmodel)).lower(
            specs["params"], specs["opt_state"], specs["batch"])
    else:
        lowered = jax.jit(jax_make_decode_step(jmodel)).lower(
            specs["params"], specs["tokens"], specs["cache"], specs["pos"])
    return analyze_hlo(lowered.compile().as_text())


def _port_cost(arch, kind, b, t):
    cfg = get_config(arch).reduced()
    cost, *_ = walk_step(cfg, build_model(cfg), InputShape("x", t, b, kind),
                         make_host_mesh("cpu"))
    return cost


def _identity_checkpoint(f=None, **_):
    return f if f is not None else (lambda g: g)


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "deepseek_v2_lite"])
def test_train_step_flops_are_the_references(arch, monkeypatch):
    """Batch 2 x 64 tokens.  Without the reference's rematerialization the
    counts agree within 1e-3; with it the reference adds a recomputed
    forward, which is positive and at most the port's forward."""
    port = _port_cost(arch, "train", 2, 64).flops
    with_remat = _reference_cost(arch, "train", 2, 64).flops
    monkeypatch.setattr(jax, "checkpoint", _identity_checkpoint)
    without = _reference_cost(arch, "train", 2, 64).flops
    assert abs(port - without) <= 1e-3 * without
    forward = port / 3          # the port's step: forward + 2x backward
    assert 0 < with_remat - without <= forward * (1 + 1e-3)


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "deepseek_v2_lite"])
def test_decode_step_flops_are_the_references(arch):
    """Batch 2 at a 128-position cache."""
    port = _port_cost(arch, "decode", 2, 128).flops
    ref = _reference_cost(arch, "decode", 2, 128).flops
    assert abs(port - ref) <= 1e-3 * ref


# ----------------------------------------------- collapsed loops: values
def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


FLASH_CASES = {
    "flash_full": lambda: ((_randn(2, 64, 4, 16), _randn(2, 64, 2, 16, seed=1),
                            _randn(2, 64, 2, 16, seed=2)),
                           dict(window=24, bq=16, bk=8)),
    "flash_decode": lambda: ((_randn(2, 1, 4, 16), _randn(2, 64, 2, 16, seed=1),
                              _randn(2, 64, 2, 16, seed=2), 37),
                             dict(window=24, bk=8)),
    "flash_latent_full": lambda: ((_randn(2, 64, 4, 32),
                                   _randn(2, 64, 4, 8, seed=1),
                                   _randn(2, 64, 32, seed=2),
                                   _randn(2, 64, 8, seed=3), 0.125),
                                  dict(bq=16, bk=8)),
    "flash_latent_decode": lambda: ((_randn(2, 1, 4, 32),
                                     _randn(2, 1, 4, 8, seed=1),
                                     _randn(2, 64, 32, seed=2),
                                     _randn(2, 64, 8, seed=3), 41, 0.125),
                                    dict(bk=8)),
}


@pytest.mark.parametrize("name", FLASH_CASES)
def test_flash_outside_a_walk_is_the_plain_loop(name, monkeypatch):
    args, kw = FLASH_CASES[name]()
    fn = getattr(flash, name)
    got = fn(*args, **kw)
    monkeypatch.setattr(flash, "counted_range", range)
    assert torch.equal(got, fn(*args, **kw))


def _fake(args, mode):
    return tuple(mode.from_tensor(a) if torch.is_tensor(a) else a
                 for a in args)


@pytest.mark.parametrize("name", FLASH_CASES)
def test_flash_collapsed_counts_are_the_full_loops(name, monkeypatch):
    args, kw = FLASH_CASES[name]()
    fn = getattr(flash, name)
    with FlopCounterMode(display=False) as full:
        fn(*args, **kw)
    mode = FakeTensorMode()
    fake = _fake(args, mode)
    with mode:
        collapsed = analyze(fn, *fake, **kw)
        monkeypatch.setattr(flash, "counted_range", range)
        walked_in_full = analyze(fn, *fake, **kw)
    assert collapsed.flops == full.get_total_flops() > 0
    assert collapsed.bytes_ == walked_in_full.bytes_


def test_flash_collapsed_backward_flops_are_the_full_loops(monkeypatch):
    """The backward of a collapsed key loop takes its body's weight."""
    args, kw = FLASH_CASES["flash_full"]()

    def step(q, k, v):
        out = flash.flash_full(q, k, v, **kw)
        return torch.autograd.grad(out.sum(), (q, k, v))

    grads = [a.clone().requires_grad_(True) for a in args]
    with FlopCounterMode(display=False) as full:
        step(*grads)
    mode = FakeTensorMode()
    with mode:
        fake = [mode.from_tensor(a).requires_grad_(True) for a in args]
        assert analyze(step, *fake).flops == full.get_total_flops()


# ------------------------------- the chunked scans against their old form
def _wkv_chunked_list(r, k, v, w, u, state0):
    """`models.ssm._wkv_chunked` as it was: one output per chunk, joined
    by `torch.cat` at the end."""
    b, t, h, hd = r.shape
    L, c = ssm._WKV_CHUNK, ssm._WKV_SUB
    ns = L // c
    dev = r.device
    strict = torch.ones(L, L, dtype=torch.bool, device=dev).tril(-1)
    sub_of = torch.arange(L, device=dev) // c                   # (L,)
    valid_ts = sub_of[:, None] >= torch.arange(ns, device=dev)[None, :]
    valid_ts = valid_ts[None, :, :, None, None]                 # (1,L,ns,1,1)
    s0, outs = state0, []
    for t0 in range(0, t, L):
        rk, kk, vk, wk = (z[:, t0:t0 + L] for z in (r, k, v, w))
        logw = torch.log(torch.clamp_min(wk, 1e-38))
        l = torch.cumsum(logw, dim=1)                          # <= 0
        l_prev = l - logw                                      # l_{t-1}
        ref = l_prev.reshape(b, ns, c, h, hd)[:, :, 0]         # (B,ns,H,hd)
        e_r = l_prev[:, :, None] - ref[:, None]                # (B,L,ns,H,hd)
        rdx = rk[:, :, None] * torch.where(valid_ts, e_r,
                                           -torch.inf).exp()
        e_k = ref[:, :, None] - l.reshape(b, ns, c, h, hd)     # (B,ns,c,H,hd)
        kdx = kk.reshape(b, ns, c, h, hd) * torch.exp(e_k)
        a = torch.einsum("btshk,bsjhk->bhtsj", rdx, kdx).reshape(b, h, L, L)
        a = torch.where(strict, a, torch.zeros((), device=dev))
        out_intra = torch.einsum("bhtj,bjhv->bthv", a, vk)
        diag = torch.einsum("blhk,blhk->blh", rk * u[None, None], kk)
        out_inter = torch.einsum("blhk,bhkv->blhv", rk * torch.exp(l_prev),
                                 s0)
        outs.append(out_inter + out_intra + diag[..., None] * vk)
        decay_to_end = torch.exp(l[:, -1:] - l)                # (B,L,H,hd)
        s0 = torch.exp(l[:, -1])[:, :, :, None] * s0 + torch.einsum(
            "bjhk,bjhv->bhkv", kk * decay_to_end, vk)
    return s0, torch.cat(outs, dim=1)


def _ssd_plain_list(x, b, c, dt, a, state0, *, chunk):
    """`ssd_chunk_scan_plain` as it was: one output per chunk, joined by
    `torch.cat` at the end."""
    xf, bf, cf, dtf, af, h = (u.float() for u in (x, b, c, dt, a, state0))
    t = x.shape[1]
    ys = []
    for t0 in range(0, t, chunk):
        sl = slice(t0, t0 + chunk)
        xc, bc, cc, dtc = xf[:, sl], bf[:, sl], cf[:, sl], dtf[:, sl]
        n = xc.shape[1]
        l = torch.cumsum(dtc * af, dim=1)
        y = torch.exp(l)[..., None] * torch.einsum("bln,bhdn->blhd", cc, h)
        s_cb = torch.einsum("btn,bjn->btj", cc, bc)
        ldiff = l[:, :, None, :] - l[:, None, :, :]
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        w = torch.exp(torch.where(causal, ldiff, -torch.inf)) \
            * s_cb[..., None]
        xdt = xc * dtc[..., None]
        ys.append(y + torch.einsum("btjh,bjhd->bthd", w, xdt))
        decay_end = torch.exp(l[:, -1:] - l)
        h = torch.exp(l[:, -1])[..., None, None] * h + torch.einsum(
            "bjhd,bjn->bhdn", xdt * decay_end[..., None], bc)
    return h.to(state0.dtype), torch.cat(ys, dim=1).to(x.dtype)


def _wkv_operands(t=192, seed=4):
    r, k, v = (_randn(2, t, 3, 8, seed=seed + i) for i in range(3))
    w = torch.sigmoid(_randn(2, t, 3, 8, seed=seed + 3)) * 0.5 + 0.45
    return [r, k, v, w, _randn(3, 8, seed=seed + 4),
            _randn(2, 3, 8, 8, seed=seed + 5)]


def _ssd_operands(t, seed=6, dtype=torch.float32):
    x = _randn(2, t, 3, 8, seed=seed)
    b, c = _randn(2, t, 5, seed=seed + 1), _randn(2, t, 5, seed=seed + 2)
    dt = torch.nn.functional.softplus(_randn(2, t, 3, seed=seed + 3))
    a = -torch.exp(_randn(3, seed=seed + 4))
    s0 = _randn(2, 3, 8, 5, seed=seed + 5)
    return [x.to(dtype), b.to(dtype), c.to(dtype), dt.to(dtype), a, s0]


def _grads(fn, ops, wants):
    ops = [u.clone().requires_grad_(w) for u, w in zip(ops, wants)]
    outs = fn(*ops)
    gs = torch.autograd.grad(sum(o.float().square().sum() for o in outs),
                             [u for u, w in zip(ops, wants) if w])
    return [o.detach() for o in outs], gs


def test_the_chunked_wkv_is_its_list_form_bit_for_bit():
    ops = _wkv_operands()
    wants = (True, True, True, True, True, False)
    new, old = (_grads(f, ops, wants) for f in (ssm._wkv_chunked,
                                                _wkv_chunked_list))
    assert all(torch.equal(a, b) for a, b in zip(new[0], old[0]))
    assert all(torch.equal(a, b) for a, b in zip(new[1], old[1]))


@pytest.mark.parametrize("t,chunk", [(128, 64), (150, 64), (48, 64),
                                     (200, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_ssd_plain_scan_is_its_list_form_bit_for_bit(t, chunk, dtype):
    ops = _ssd_operands(t, dtype=dtype)
    wants = (True, True, True, True, True, True)

    def new(*u):
        return ssd_chunk.ssd_chunk_scan_plain(*u, chunk=chunk)

    def old(*u):
        return _ssd_plain_list(*u, chunk=chunk)

    got, want = _grads(new, ops, wants), _grads(old, ops, wants)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("scan", ["wkv", "ssd"])
def test_the_collapsed_scans_count_the_full_loops(scan, monkeypatch):
    if scan == "wkv":
        ops, fn, mod = _wkv_operands(), ssm._wkv_chunked, ssm
    else:
        ops, mod = _ssd_operands(150), ssd_chunk
        fn = ssd_chunk.ssd_chunk_scan_plain
    with FlopCounterMode(display=False) as full:
        fn(*ops)
    mode = FakeTensorMode()
    fake = _fake(ops, mode)
    with mode:
        collapsed = analyze(fn, *fake)
        monkeypatch.setattr(mod, "counted_range", range)
        walked_in_full = analyze(fn, *fake)
    assert collapsed.flops == full.get_total_flops() > 0
    assert collapsed.bytes_ == walked_in_full.bytes_
