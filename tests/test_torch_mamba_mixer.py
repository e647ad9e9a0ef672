"""The Mamba2 mixer's pointwise kernels (`kernels/mamba_mixer`) and the
published Zamba2's mixer through them.

On the CPU: the plain versions are the mixer's expressions as they stood
before the kernels (`_conv_as_before`, `_norm_as_before` below), bit for
bit, at the reduced layout with a zero carry, a live carry and fewer
tokens than the conv's K - 1 (a decode step); the group-major xs, B, C
and dt are the per-group `.contiguous()` slices the scan took before;
the wrappers compute the plain versions for CPU tensors and refuse what
the kernels do not take; the model's mixer is bit for bit the mixer
before the kernels and counts no fused layer; the benchmark's
`mixer_fused.prefill` reads the counter.  Marked `cuda` (each skips from
inside the test where there is no card; on a card, `PYTHONPATH=src
python -m pytest -q -m cuda tests/test_torch_mamba_mixer.py`): each
kernel against its plain version at zamba2-7b's widths, the reduced
ones, a ragged T and T = 1 with a live carry; the wrappers' refusals on
the card, misaligned operands among them; the reduced model on
the card through the kernels against itself through the plain versions;
and a full-width prefill that counts 81 fused layers.
"""
import dataclasses
import sys
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest  # noqa: E402

from repro_torch.kernels.mamba_mixer import (  # noqa: E402
    gated_rms_norm, gated_rms_norm_ref, mamba_conv_silu,
    mamba_conv_silu_ref, next_carry)
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models import zamba2_published as zp  # noqa: E402

EPS = zp.GATED_NORM_EPS


@dataclasses.dataclass(frozen=True)
class Widths:
    """One mixer's widths: H heads of P, G groups, state N, K taps."""
    h: int
    p: int
    g: int
    n: int
    k: int = 4

    @property
    def d_inner(self):
        return self.h * self.p

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.g * self.n

    @property
    def width(self):
        """The in_proj output's [z | xBC | dt]."""
        return self.d_inner + self.conv_dim + self.h


REDUCED = Widths(h=8, p=16, g=2, n=16)          # `Zamba2Layout.reduced()`
PUBLISHED = Widths(h=112, p=64, g=2, n=64)      # zamba2-7b
OFF_FOURS = Widths(h=6, p=10, g=2, n=12)        # widths the kernels refuse


def _inputs(w: Widths, b: int, t: int, dtype, live: bool, device="cpu",
            seed=0):
    """An in_proj output (B, T, width) and its (z, xbc, dt_raw) views, a
    carry (zero or drawn), the conv weights and bias, dt_bias, D and the
    norm's gate."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    proj = draw(b, t, w.width)
    z, xbc, dt_raw = torch.split(proj, [w.d_inner, w.conv_dim, w.h], dim=-1)
    carry = draw(b, w.k - 1, w.conv_dim) if live else torch.zeros(
        (b, w.k - 1, w.conv_dim), dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return types.SimpleNamespace(
        proj=proj, z=z, xbc=xbc, dt_raw=dt_raw, carry=carry,
        conv_w=draw(w.k, w.conv_dim, scale=w.k ** -0.5),
        conv_b=draw(w.conv_dim, scale=w.k ** -0.5),
        dt_bias=torch.randn((w.h,), generator=gen, **f32) - 4.0,
        d=torch.rand((w.h,), generator=gen, **f32) + 0.5,
        gate=draw(w.d_inner, scale=0.5) + 1.0)


def _conv_as_before(w: Widths, x):
    """The mixer's conv, SiLU and softplus before the kernels, then the
    per-group slices its scan took: (xs, B, C, dt) lists, one a group."""
    b, t, _ = x.xbc.shape
    ext = torch.cat([x.carry, x.xbc], dim=1)
    extf, cw = ext.float(), x.conv_w.float()
    acc = extf[:, 0:t] * cw[0] + x.conv_b.float()
    for i in range(1, w.k):
        acc.addcmul_(extf[:, i:i + t], cw[i])
    xs, bmat, cmat = torch.split(F.silu(acc),
                                 [w.d_inner, w.g * w.n, w.g * w.n], dim=-1)
    dt = F.softplus(x.dt_raw.float() + x.dt_bias)
    xs = xs.reshape(b, t, w.h, w.p)
    bmat, cmat = bmat.reshape(b, t, w.g, w.n), cmat.reshape(b, t, w.g, w.n)
    per = w.h // w.g
    hs = [slice(g * per, (g + 1) * per) for g in range(w.g)]
    return ([xs[:, :, s].contiguous() for s in hs],
            [bmat[:, :, g].contiguous() for g in range(w.g)],
            [cmat[:, :, g].contiguous() for g in range(w.g)],
            [dt[:, :, s].contiguous() for s in hs], ext, xs)


def _norm_as_before(w: Widths, y, xs, z, d, gate, dtype):
    """The mixer's D skip, gate and gated norm before the kernels, over
    all the groups at once: y and xs (B, T, H, P)."""
    b, t = y.shape[:2]
    v = (y + d[:, None] * xs).reshape(b, t, w.d_inner)
    v = (v * F.silu(z.float())).reshape(b, t, w.g, w.d_inner // w.g)
    v = v * torch.rsqrt(v.square().mean(-1, keepdim=True) + EPS)
    return (v.reshape(b, t, w.d_inner) * gate).to(dtype)


# ------------------------------------------------------------------ CPU
CASES = {"zero carry": (2, 37, False), "live carry": (2, 29, True),
         "decode step": (3, 1, True), "T < K - 1": (2, 2, True),
         "T = K - 1": (1, 3, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_the_plain_conv_is_the_mixer_before_bit_for_bit(case, dtype):
    b, t, live = CASES[case]
    x = _inputs(REDUCED, b, t, dtype, live, seed=t)
    got = mamba_conv_silu_ref(x.xbc, x.carry, x.conv_w, x.conv_b, x.dt_raw,
                              x.dt_bias, ngroups=REDUCED.g,
                              headdim=REDUCED.p)
    xs, bm, cm, dt, ext, _ = _conv_as_before(REDUCED, x)
    per = REDUCED.h // REDUCED.g
    shapes = [(REDUCED.g, b, t, per, REDUCED.p), (REDUCED.g, b, t, REDUCED.n),
              (REDUCED.g, b, t, REDUCED.n), (REDUCED.g, b, t, per)]
    for out, want, shape in zip(got, (xs, bm, cm, dt), shapes):
        assert out.shape == shape and out.dtype == torch.float32
        assert out.is_contiguous()
        for g in range(REDUCED.g):
            assert torch.equal(out[g], want[g])
    assert torch.equal(next_carry(x.carry, x.xbc), ext[:, -(REDUCED.k - 1):])


@pytest.mark.parametrize("case", list(CASES))
def test_the_group_major_slices_are_the_scans_dense_operands(case):
    """Group g of each output, seen as the (B, T, G, ...) view the scan
    takes, is the dense slice the scan took before, with no copy."""
    b, t, live = CASES[case]
    x = _inputs(REDUCED, b, t, torch.float32, live, seed=1)
    xs, bm, cm, dt = mamba_conv_silu(x.xbc, x.carry, x.conv_w, x.conv_b,
                                     x.dt_raw, x.dt_bias, ngroups=REDUCED.g,
                                     headdim=REDUCED.p)
    before = _conv_as_before(REDUCED, x)
    for out, want in zip((xs, bm, cm, dt), before):
        view = out.movedim(0, 2)
        for g in range(REDUCED.g):
            dense = view[:, :, g]
            assert dense.is_contiguous()
            assert dense.data_ptr() == out[g].data_ptr()
            assert torch.equal(dense, want[g])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_the_plain_norm_is_the_mixer_before_bit_for_bit(case, dtype):
    b, t, live = CASES[case]
    w = REDUCED
    x = _inputs(w, b, t, dtype, live, seed=2 * t + 1)
    gen = torch.Generator().manual_seed(t)
    y = torch.randn((b, t, w.h, w.p), generator=gen)
    _, _, _, _, _, xs = _conv_as_before(w, x)
    want = _norm_as_before(w, y, xs, x.z, x.d, x.gate, dtype)
    out = torch.full((b, t, w.d_inner), float("nan"), dtype=dtype)
    dg, per = w.d_inner // w.g, w.h // w.g
    for g in range(w.g):
        cols, heads = slice(g * dg, (g + 1) * dg), slice(g * per,
                                                         (g + 1) * per)
        yg, xg = y[:, :, heads].contiguous(), xs[:, :, heads].contiguous()
        plain = gated_rms_norm_ref(yg, xg, x.z[..., cols], x.d[heads],
                                   x.gate[cols], eps=EPS)
        assert torch.equal(plain, want[..., cols])
        before = gated_rms_norm.launches
        got = gated_rms_norm(yg, xg, x.z[..., cols], x.d[heads],
                             x.gate[cols], out[..., cols], eps=EPS)
        assert gated_rms_norm.launches == before
        assert got.data_ptr() == out[..., cols].data_ptr()
    assert torch.equal(out, want)


@pytest.mark.parametrize("t", [0, 1, 2, 3, 9])
def test_next_carry_is_the_last_rows_of_the_concatenation(t):
    carry = torch.randn(2, 3, 5)
    xbc = torch.randn(2, t, 5)
    got = next_carry(carry, xbc)
    assert torch.equal(got, torch.cat([carry, xbc], dim=1)[:, -3:])
    if t >= 3:                                  # a view, nothing copied
        assert got.data_ptr() == xbc[:, t - 3:].data_ptr()


def _refused_conv(case):
    x = _inputs(REDUCED, 2, 8, torch.bfloat16, True)
    args = dict(xbc=x.xbc, carry=x.carry, conv_w=x.conv_w, conv_b=x.conv_b,
                dt_raw=x.dt_raw, dt_bias=x.dt_bias)
    kw = dict(ngroups=REDUCED.g, headdim=REDUCED.p)
    if case == "carry rows":
        args["carry"] = x.carry[:, :1]
    elif case == "conv_b shape":
        args["conv_b"] = x.conv_b[1:]
    elif case == "dt heads":
        args["dt_raw"] = x.dt_raw[..., 1:]
    elif case == "groups":
        kw["ngroups"] = 3
    elif case == "headdim":
        kw["headdim"] = 24                     # leaves no room for B, C
    elif case == "taps":
        args["conv_w"] = torch.zeros((3, REDUCED.conv_dim),
                                     dtype=torch.bfloat16)
        args["carry"] = torch.zeros((2, 2, REDUCED.conv_dim),
                                    dtype=torch.bfloat16)
    elif case == "widths off fours":
        y = _inputs(OFF_FOURS, 2, 8, torch.bfloat16, True)
        args = dict(xbc=y.xbc, carry=y.carry, conv_w=y.conv_w,
                    conv_b=y.conv_b, dt_raw=y.dt_raw, dt_bias=y.dt_bias)
        kw = dict(ngroups=OFF_FOURS.g, headdim=OFF_FOURS.p)
    elif case == "2-d xbc":
        args["xbc"] = x.xbc[0]
    elif case == "float16":
        args = {k: v.half() if k != "dt_bias" else v for k, v in args.items()}
    elif case == "mixed dtypes":
        args["carry"] = x.carry.float()
    elif case == "dt_bias bf16":
        args["dt_bias"] = x.dt_bias.bfloat16()
    return args, kw


@pytest.mark.parametrize("case", [
    "carry rows", "conv_b shape", "dt heads", "groups", "headdim", "taps",
    "widths off fours", "2-d xbc", "float16", "mixed dtypes",
    "dt_bias bf16"])
def test_the_conv_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, kw = _refused_conv(case)
    err = TypeError if case in ("float16", "mixed dtypes",
                                "dt_bias bf16") else ValueError
    with pytest.raises(err):
        mamba_conv_silu(**args, **kw)


def _refused_norm(case, device="cpu"):
    w = REDUCED
    x = _inputs(w, 2, 8, torch.bfloat16, True, device=device)
    dg, per = w.d_inner // w.g, w.h // w.g
    f32 = dict(dtype=torch.float32, device=device)
    args = dict(y=torch.randn((2, 8, per, w.p), **f32),
                xs=torch.randn((2, 8, per, w.p), **f32), z=x.z[..., :dg],
                d=x.d[:per], gate=x.gate[:dg],
                out=torch.empty((2, 8, w.d_inner), dtype=torch.bfloat16,
                                device=device)[..., :dg])
    if case == "y 3-d":
        args["y"] = args["y"].flatten(2)
    elif case == "xs shape":
        args["xs"] = args["xs"][:, 1:]
    elif case == "d heads":
        args["d"] = x.d
    elif case == "gate width":
        args["gate"] = x.gate
    elif case == "out width":
        args["out"] = torch.empty((2, 8, w.d_inner), dtype=torch.bfloat16,
                                  device=device)
    elif case == "y bf16":
        args["y"] = args["y"].bfloat16()
    elif case == "mixed dtypes":
        args["gate"] = args["gate"].float()
    elif case == "float16":
        args.update(z=args["z"].half(), gate=args["gate"].half(),
                    out=args["out"].half())
    elif case == "z strided":
        args["z"] = x.proj[..., :2 * dg:2]
    elif case == "y strided":
        args["y"] = torch.randn((2, 8, per, 2 * w.p), **f32)[..., ::2]
    elif case == "P off fours":
        o = OFF_FOURS
        ho, dgo = o.h // o.g, o.d_inner // o.g
        y = _inputs(o, 2, 8, torch.bfloat16, True, device=device)
        args = dict(y=torch.randn((2, 8, ho, o.p), **f32),
                    xs=torch.randn((2, 8, ho, o.p), **f32),
                    z=y.z[..., :dgo], d=y.d[:ho], gate=y.gate[:dgo],
                    out=torch.empty((2, 8, dgo), dtype=torch.bfloat16,
                                    device=device))
    elif case == "float32 on cuda":
        args.update(z=args["z"].float(), gate=args["gate"].float(),
                    out=args["out"].float())
    elif case == "y misaligned":
        args["y"] = torch.randn(1 + args["y"].numel(), **f32)[1:].view(
            args["y"].shape)
    elif case == "z misaligned":
        args["z"] = x.proj[..., 1:1 + dg]
    return args


NORM_REFUSALS = {"y 3-d": ValueError, "xs shape": ValueError,
                 "d heads": ValueError, "gate width": ValueError,
                 "out width": ValueError, "y bf16": TypeError,
                 "mixed dtypes": TypeError, "float16": TypeError,
                 "P off fours": ValueError}


@pytest.mark.parametrize("case", list(NORM_REFUSALS))
def test_the_norm_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(NORM_REFUSALS[case]):
        gated_rms_norm(**_refused_norm(case), eps=EPS)


def _mixer_as_before(model, p, h, state, carry):
    """`Zamba2PublishedModel._mixer` as it was before the kernels."""
    cfg = model.cfg
    b, t, _ = h.shape
    g, n, k = cfg.mamba_ngroups, cfg.mamba_d_state, cfg.mamba_d_conv
    z, xbc, dt_raw = torch.split(
        h @ p["w_in"], [cfg.d_inner, cfg.conv_dim, cfg.n_mamba_heads],
        dim=-1)
    ext = torch.cat([carry, xbc], dim=1)
    extf, w = ext.float(), p["conv_w"].float()
    acc = extf[:, 0:t] * w[0] + p["conv_b"].float()
    for i in range(1, k):
        acc.addcmul_(extf[:, i:i + t], w[i])
    xs, bmat, cmat = torch.split(F.silu(acc),
                                 [cfg.d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    xs = xs.reshape(b, t, cfg.n_mamba_heads, cfg.mamba_headdim)
    per = cfg.n_mamba_heads // g
    ys, finals = [], []
    for gi in range(g):
        hs = slice(gi * per, (gi + 1) * per)
        sf, y = zp.ssd_chunk_scan(
            xs[:, :, hs].contiguous(), bmat.reshape(b, t, g, n)[:, :, gi]
            .contiguous(), cmat.reshape(b, t, g, n)[:, :, gi].contiguous(),
            dt[:, :, hs].contiguous(), (-torch.exp(p["A_log"]))[hs]
            .contiguous(), state[:, hs].contiguous())
        ys.append(y)
        finals.append(sf)
    y = (torch.cat(ys, dim=2) + p["D"][:, None] * xs).reshape(
        b, t, cfg.d_inner)
    y = (y * F.silu(z.float())).reshape(b, t, g, cfg.d_inner // g)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + EPS)
    y = (y.reshape(b, t, cfg.d_inner) * p["norm_gate"]).to(h.dtype)
    return y @ p["w_out"], torch.cat(finals, dim=1), ext[:, -(k - 1):]


def _tiny(dtype, device="cpu"):
    cfg = dataclasses.replace(get_config("zamba2-7b-instruct").reduced(),
                              dtype=dtype)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator(device=device)
                                  .manual_seed(3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_the_models_mixer_is_the_mixer_before_bit_for_bit(case, dtype):
    b, t, live = CASES[case]
    cfg, model, params = _tiny(dtype)
    gen = torch.Generator().manual_seed(5)
    dt = zp.DTYPES[dtype]
    h = torch.randn((b, t, cfg.hidden_size), generator=gen).to(dt)
    state = torch.randn((b, cfg.n_mamba_heads, cfg.mamba_headdim,
                         cfg.mamba_d_state), generator=gen) * float(live)
    carry = (torch.randn((b, cfg.mamba_d_conv - 1, cfg.conv_dim),
                         generator=gen) * float(live)).to(dt)
    model._tally = {}
    got = model._mixer(params["layers"][2], h, state, carry)
    want = _mixer_as_before(model, params["layers"][2], h, state, carry)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)
    assert model._tally == {"ssd_calls": cfg.mamba_ngroups}


def test_a_cpu_prefill_counts_no_fused_layer():
    cfg, model, params = _tiny("bfloat16")
    tokens = torch.randint(0, cfg.vocab_size, (2, 11),
                           generator=torch.Generator().manual_seed(4))
    before = (mamba_conv_silu.launches, gated_rms_norm.launches)
    model.prefill(params, tokens, model.init_cache(2, 12, "cpu"))
    assert (mamba_conv_silu.launches, gated_rms_norm.launches) == before
    assert model.last_prefill_counts["mixer_fused"] == 0


@pytest.mark.parametrize("counters,want", [
    ([{"mixer_fused": 81, "ssd_calls": 162}] * 3, 81.0),
    ([{"mixer_fused": 81}, {"mixer_fused": 0}], 40.5),
    ([{"ssd_calls": 162}] * 3, None),            # a program without it
    ([], None)])
def test_the_benchmark_reads_the_counter(counters, want):
    run = types.SimpleNamespace(traced=[{"counters": c} for c in counters])
    assert manifest.reader("mixer_fused.prefill").read(run) == want


# ---------------------------------------------------------------- card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close_f32(got, want):
    """fp32 outputs of one arithmetic in another instruction order (fused
    multiply-adds, the card's exp): a few ulps of the largest term."""
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _hold_conv(w: Widths, b, t, live, device, seed=0):
    x = _inputs(w, b, t, torch.bfloat16, live, device=device, seed=seed)
    args = (x.xbc, x.carry, x.conv_w, x.conv_b, x.dt_raw, x.dt_bias)
    before = mamba_conv_silu.launches
    got = mamba_conv_silu(*args, ngroups=w.g, headdim=w.p)
    torch.cuda.synchronize()
    assert mamba_conv_silu.launches == before + 1
    want = mamba_conv_silu_ref(*args, ngroups=w.g, headdim=w.p)
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == torch.float32
        _close_f32(a, e)
    return x, got


def _hold_norm(w: Widths, x, xs, device, seed=0):
    """Each group's norm against its plain version on the card: the same
    fp32 value rounded once to bf16, so a handful of outputs may round
    the other way, one bf16 step apart; where y and D xs nearly cancel,
    the kernel's fused multiply-add and the plain version's product and
    sum differ by an fp32 rounding of the terms, a hair of the row's
    rms (2^-16 of it is room to spare)."""
    b, t = x.xbc.shape[:2]
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.full((b, t, w.d_inner), float("nan"), dtype=torch.bfloat16,
                     device=device)
    dg, per = w.d_inner // w.g, w.h // w.g
    for g in range(w.g):
        cols, heads = slice(g * dg, (g + 1) * dg), slice(g * per,
                                                         (g + 1) * per)
        y = torch.randn((b, t, per, w.p), generator=gen, device=device)
        before = gated_rms_norm.launches
        gated_rms_norm(y, xs[g], x.z[..., cols], x.d[heads], x.gate[cols],
                       out[..., cols], eps=EPS)
        torch.cuda.synchronize()
        assert gated_rms_norm.launches == before + 1
        want = gated_rms_norm_ref(y, xs[g], x.z[..., cols], x.d[heads],
                                  x.gate[cols], eps=EPS).float()
        got = out[..., cols].float()
        rms = want.square().mean(-1, keepdim=True).sqrt()
        step = 2.0 ** -7 * want.abs() + 2.0 ** -16 * rms
        over = float(((got - want).abs() / step).max())
        assert over <= 1.0, over
        assert float((got != want).float().mean()) < 0.01
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("t,live", [(1024, False), (1024, True), (77, True),
                                    (1, True)])
def test_the_kernels_match_plain_at_zamba2_widths(cuda, t, live):
    x, (xs, _, _, _) = _hold_conv(PUBLISHED, 4, t, live, cuda, seed=t)
    _hold_norm(PUBLISHED, x, xs, cuda, seed=t)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,live", [(2, 37, False), (2, 1000, True),
                                      (3, 1, True), (2, 2, True)])
def test_the_kernels_match_plain_at_the_reduced_widths(cuda, b, t, live):
    x, (xs, _, _, _) = _hold_conv(REDUCED, b, t, live, cuda, seed=b * t)
    _hold_norm(REDUCED, x, xs, cuda, seed=t)


@pytest.mark.cuda
def test_the_wrappers_refuse_on_the_card(cuda):
    x = _inputs(REDUCED, 2, 8, torch.bfloat16, True, device=cuda)
    kw = dict(ngroups=REDUCED.g, headdim=REDUCED.p)
    with pytest.raises(TypeError):                  # float32 on the card
        mamba_conv_silu(x.xbc.float(), x.carry.float(), x.conv_w.float(),
                        x.conv_b.float(), x.dt_raw.float(), x.dt_bias, **kw)
    lagged = torch.cat([x.carry, x.carry], dim=1)[:, ::2]   # rows strided
    with pytest.raises(ValueError, match="contiguous"):
        mamba_conv_silu(x.xbc, lagged, x.conv_w, x.conv_b, x.dt_raw,
                        x.dt_bias, **kw)
    with pytest.raises(ValueError, match="operand xbc"):
        wide = torch.cat([x.xbc, x.xbc], dim=-1)[..., ::2]
        mamba_conv_silu(wide, x.carry, x.conv_w, x.conv_b, x.dt_raw,
                        x.dt_bias, **kw)
    with pytest.raises(ValueError):
        mamba_conv_silu(x.xbc, x.carry.cpu(), x.conv_w, x.conv_b, x.dt_raw,
                        x.dt_bias, **kw)
    with pytest.raises(ValueError, match="aligned"):     # 2 bytes off
        shifted = x.proj[..., 1:1 + REDUCED.conv_dim]
        mamba_conv_silu(shifted, x.carry, x.conv_w, x.conv_b, x.dt_raw,
                        x.dt_bias, **kw)
    for case, err in (("z strided", ValueError), ("y strided", ValueError),
                      ("float32 on cuda", TypeError),
                      ("y misaligned", ValueError),
                      ("z misaligned", ValueError)):
        with pytest.raises(err):
            gated_rms_norm(**_refused_norm(case, cuda), eps=EPS)
    torch.cuda.synchronize()


def _plain_wrappers(monkeypatch):
    """The mixer through the plain versions, on whatever device."""
    def conv(*args, ngroups, headdim):
        return mamba_conv_silu_ref(*args, ngroups=ngroups, headdim=headdim)

    def norm(y, xs, z, d, gate, out, *, eps):
        return out.copy_(gated_rms_norm_ref(y, xs, z, d, gate, eps=eps))
    conv.launches = norm.launches = 0
    monkeypatch.setattr(zp, "mamba_conv_silu", conv)
    monkeypatch.setattr(zp, "gated_rms_norm", norm)


@pytest.mark.cuda
def test_the_reduced_model_on_the_card_through_the_kernels(cuda,
                                                          monkeypatch):
    """Prefill and decode steps of the reduced bf16 model through the
    kernels against the same model through the plain versions on the
    card: the kernels differ by a bf16 rounding here and there, which
    seven layers carry to the logits at well under a percent."""
    cfg, model, params = _tiny("bfloat16", cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 45), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(6))

    def run():
        cache = model.init_cache(2, 50, cuda)
        with torch.no_grad():
            out = [model.prefill(params, tokens, cache)[0]]
            counts = dict(model.last_prefill_counts)
            for step in range(3):
                out.append(model.decode_step(params, tokens[:, step:step + 1],
                                             cache, 45 + step)[0])
        torch.cuda.synchronize()
        return out, counts

    got, counts = run()
    assert counts["mixer_fused"] == cfg.num_hidden_layers
    _plain_wrappers(monkeypatch)
    want, plain = run()
    assert plain["mixer_fused"] == 0
    for a, e in zip(got, want):
        err = float((a.float() - e.float()).abs().max()
                    / e.float().abs().max())
        assert err <= 1e-2, err


@pytest.mark.cuda
def test_a_full_width_prefill_fuses_every_mamba_layer(cuda):
    cfg = get_config("zamba2-7b-instruct")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    with torch.no_grad():
        logits, _ = model.prefill(params, tokens,
                                  model.init_cache(4, 1024, cuda))
    torch.cuda.synchronize()
    counts = model.last_prefill_counts
    assert counts["mixer_fused"] == cfg.num_hidden_layers == 81
    assert counts["ssd_calls"] == 162
    assert bool(torch.isfinite(logits.float()).all())
