"""The port's decode kernels and their lowerings against the JAX package's,
on the CPU.

On CPU tensors `decode_attention` and `ssd_chunk_scan` compute their plain
PyTorch versions; those are held here against the reference's Pallas
kernels (`interpret=True`) and its plain oracles on the same numpy inputs.
Plain-PyTorch mirrors of the CUDA kernels' own arithmetic (the attention
kernel's per-run online softmax and fixed-order merge under its launch
plan; the SSD decode kernel's recurrent register step) are held against the
reference's Pallas kernels too.  The unit lowerings, `_unpack_params` and
the head / kv-block / ssm-state split lowerings on two CPU groups are held
against the reference's unit oracles and the port's unsplit math;
`validate_axis_split` against the reference's.
"""
import functools
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import AttnOp as JaxAttnOp
from repro.core.types import SSMOp as JaxSSMOp
from repro.kernels import registry as jax_registry
from repro.kernels.decode_attention.decode_attention import (
    decode_attention as jax_decode_attention)
from repro.kernels.decode_attention.ops import attention_unit_oracle
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_attention_ref)
from repro.kernels.ssd_chunk.ops import _unpack_params as jax_unpack_params
from repro.kernels.ssd_chunk.ops import ssm_unit_oracle
from repro.kernels.ssd_chunk.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.kernels.ssd_chunk.ssd_chunk import (
    ssd_chunk_scan as jax_ssd_chunk_scan)

from repro_torch.core.coexec import GroupLocal, SplitPlan, coexec_groups
from repro_torch.core.types import AttnOp, SSMOp
from repro_torch.kernels import registry
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  decode_attention_ref)
from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan,
                                           ssd_chunk_scan_plain, ssd_scan_ref)
from repro_torch.kernels.ssd_chunk.ops import _unpack_params

# the kernel modules (their packages export the wrappers by the same names)
da = importlib.import_module(
    "repro_torch.kernels.decode_attention.decode_attention")
sc = importlib.import_module("repro_torch.kernels.ssd_chunk.ssd_chunk")

# fp32 softmax-weighted sums over S positions, taken in another order (and
# with the scale applied before or after the dot product)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
# the chunked SSD form reassociates the recurrence: exp(l_t - l_j) from a
# cumulative sum of up to 256 terms against step-by-step products (the
# reference's own kernel-vs-scan tolerance)
SSD_TOL = dict(rtol=5e-4, atol=5e-4)
# one algorithm, the same fp32 operations, grouped differently
SAME_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _attn_inputs(h, kv, hd, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, hd)).astype(np.float32),
            rng.standard_normal((s, kv, hd)).astype(np.float32),
            rng.standard_normal((s, kv, hd)).astype(np.float32))


def _ssd_inputs(b, t, h, hd, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, t, h, hd)).astype(f),
            rng.standard_normal((b, t, n)).astype(f),
            rng.standard_normal((b, t, n)).astype(f),
            rng.uniform(0.01, 0.5, size=(b, t, h)).astype(f),
            -rng.uniform(0.1, 1.5, size=(h,)).astype(f),
            rng.standard_normal((b, h, hd, n)).astype(f))


# ------------------------------------------------------- decode attention
@pytest.mark.parametrize("h,kv,hd,s,pos,window", [
    (4, 4, 16, 300, 299, 0),        # g = 1, S not a multiple of 512
    (8, 4, 32, 700, 650, 0),        # g = 2, pos < S - 1
    (8, 2, 16, 1024, 1023, 0),      # g = 4
    (8, 2, 64, 700, 500, 128),      # sliding window, pos < S - 1
    (4, 1, 16, 512, 511, 100),      # g = 4, window at the cache's end
])
def test_plain_decode_attention_matches_reference(h, kv, hd, s, pos, window):
    q, k, v = _attn_inputs(h, kv, hd, s, seed=h + kv + s + pos)
    before = decode_attention.launches
    out, lse = decode_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), pos, window=window)
    assert decode_attention.launches == before      # the CPU takes no kernel
    want = _np(jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), pos, window=window,
                                    interpret=True))
    np.testing.assert_allclose(_np(out), want, **ATTN_TOL)
    ref = _np(jax_decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), pos, window=window))
    np.testing.assert_allclose(_np(out), ref, **ATTN_TOL)
    np.testing.assert_allclose(
        _np(decode_attention_ref(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), pos, window=window)),
        ref, **ATTN_TOL)
    # lse: the log-sum-exp of the head's scaled, masked scores (float64)
    g = h // kv
    scores = np.einsum("hgd,shd->hgs", q.reshape(kv, g, hd).astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(hd)
    k_pos = np.arange(s)
    mask = (k_pos <= pos) & ((k_pos > pos - window) if window else True)
    sm = scores[..., mask]
    top = sm.max(-1, keepdims=True)
    want_lse = (top[..., 0] + np.log(np.exp(sm - top).sum(-1))).reshape(h)
    np.testing.assert_allclose(_np(lse), want_lse, **ATTN_TOL)


def test_plain_decode_attention_ignores_masked_positions():
    q, k, v = _attn_inputs(4, 2, 16, 128, seed=3)
    base, _ = decode_attention_plain(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), 40, window=8)
    k[41:], v[41:], k[:33], v[:33] = 999.0, -999.0, 999.0, -999.0
    poisoned, _ = decode_attention_plain(torch.tensor(q), torch.tensor(k),
                                         torch.tensor(v), 40, window=8)
    np.testing.assert_array_equal(_np(base), _np(poisoned))
    with pytest.raises(ValueError, match="attends to none"):
        decode_attention_plain(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), 200, window=8)


def test_plain_decode_attention_in_bfloat16_rounds_like_float32():
    q, k, v = _attn_inputs(8, 2, 32, 256, seed=5)
    args = [torch.tensor(a).bfloat16() for a in (q, k, v)]
    out, lse = decode_attention(*args, 255)
    want, want_lse = decode_attention_plain(*(a.float() for a in args), 255)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out.float()), _np(want), rtol=1e-2,
                               atol=1e-2)                 # one bf16 rounding
    np.testing.assert_allclose(_np(lse), _np(want_lse), **SAME_TOL)


# ---------------------------------------------------------- ssd chunk scan
@pytest.mark.parametrize("b,t,h,hd,n,chunk", [
    (1, 1, 4, 16, 8, None),          # decode: one token
    (2, 64, 3, 16, 8, None),         # one chunk of the port's default
    (1, 512, 2, 32, 16, 256),        # chunked prefill, the TPU's chunk
])
def test_plain_ssd_chunk_scan_matches_reference(b, t, h, hd, n, chunk):
    ins = _ssd_inputs(b, t, h, hd, n, seed=b + t + h)
    # the wrapper takes the port's own chunk length; the TPU's 256 goes
    # through the plain version's `chunk`
    scan = (ssd_chunk_scan if chunk is None
            else functools.partial(ssd_chunk_scan_plain, chunk=chunk))
    before = ssd_chunk_scan.launches
    sf, y = scan(*map(torch.tensor, ins))
    assert ssd_chunk_scan.launches == before
    sf_k, y_k = jax_ssd_chunk_scan(*map(jnp.asarray, ins), chunk=chunk,
                                   interpret=True)
    sf_r, y_r = jax_ssd_scan_ref(*map(jnp.asarray, ins))
    for got, want in ((y, y_k), (sf, sf_k), (y, y_r), (sf, sf_r)):
        np.testing.assert_allclose(_np(got), _np(want), **SSD_TOL)
    sf_p, y_p = ssd_scan_ref(*map(torch.tensor, ins))
    np.testing.assert_allclose(_np(y_p), _np(y_r), **SSD_TOL)
    np.testing.assert_allclose(_np(sf_p), _np(sf_r), **SSD_TOL)


def test_plain_ssd_chunk_scan_carries_state_across_ragged_chunks():
    """The chunk length is the port's own: 100 tokens in chunks of 64 (a
    ragged last chunk), 7 or 100 compute one scan."""
    ins = list(map(torch.tensor, _ssd_inputs(1, 100, 2, 16, 8, seed=9)))
    sf, y = ssd_chunk_scan_plain(*ins)
    for chunk in (7, 100):
        sf_c, y_c = ssd_chunk_scan_plain(*ins, chunk=chunk)
        np.testing.assert_allclose(_np(y_c), _np(y), **SSD_TOL)
        np.testing.assert_allclose(_np(sf_c), _np(sf), **SSD_TOL)
    with pytest.raises(ValueError, match="shape"):
        ssd_chunk_scan_plain(ins[0], ins[1], ins[2], ins[3][:, :50], ins[4],
                             ins[5])


# ------------------------------------------- the CUDA kernels' arithmetic
# kernel against plain, relative to the largest |plain| value (chip_smoke's
# KERNEL_RTOL for fp32)
MIRROR_RTOL = 5e-5


def _close_rel(got, want, rtol=MIRROR_RTOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


def _attention_mirror(q, k, v, plan):
    """`attn_runs` then `attn_merge` under `plan`, in plain PyTorch (fp32):
    each run an online softmax over its tiles with the query pre-scaled,
    then the runs' partials added in run order."""
    h, hd = q.shape
    kv = k.shape[1]
    qg = q.reshape(kv, h // kv, hd).float() / math.sqrt(hd)
    parts = []
    for first, end in plan.runs():
        m = torch.full(qg.shape[:2], -1e30)
        l = torch.zeros(qg.shape[:2])
        acc = torch.zeros(qg.shape)
        for t0 in range(first, end, plan.tile):
            t1 = min(end, t0 + plan.tile)
            s = torch.einsum("kgd,skd->kgs", qg, k[t0:t1].float())
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.exp(s - m_new[..., None])
            a = torch.exp(m - m_new)
            l = l * a + p.sum(-1)
            acc = acc * a[..., None] + torch.einsum("kgs,skd->kgd", p,
                                                    v[t0:t1].float())
            m = m_new
        parts.append((m, l, acc))
    top = torch.stack([m for m, _, _ in parts]).max(0).values
    total, acc = torch.zeros_like(top), torch.zeros(qg.shape)
    for m, l, a in parts:
        w = torch.exp(m - top)
        total = total + w * l
        acc = acc + w[..., None] * a
    return ((acc * (1.0 / total)[..., None]).reshape(h, hd),
            (top + torch.log(total)).reshape(h))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,hd,s,pos,window,resident", [
    (4, 4, 16, 300, 299, 0, 16),      # g = 1, four runs of 3 tiles each
    (8, 4, 32, 700, 650, 0, 8),       # g = 2, pos < S - 1, 2 runs
    (8, 2, 16, 1024, 1023, 0, 64),    # g = 4, a run per tile
    (8, 2, 64, 700, 500, 128, 6),     # sliding window: 3 runs of 32 + 32..
    (4, 1, 16, 512, 511, 100, 1),     # one run: merged on its own
    (6, 2, 36, 97, 96, 0, 100),       # hd * 4 = 144, a ragged last tile
    (4, 4, 112, 200, 199, 0, 528),    # zamba2-7b's hd
])
def test_attention_kernel_arithmetic_matches_reference(h, kv, hd, s, pos,
                                                       window, resident,
                                                       dtype):
    q, k, v = _attn_inputs(h, kv, hd, s, seed=h + hd + s)
    if dtype == "bfloat16":                  # bf16 inputs, compared in f32
        q, k, v = (torch.tensor(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    lo, hi = da.valid_range(s, pos, window)
    elt = 4 if dtype == "float32" else 2
    plan = da.plan_attention(lo, hi, kv, h // kv, hd, elt, 0, 0, resident)
    assert plan.nsplit == -(-(hi - lo + 1) // plan.run_len)
    out, lse = _attention_mirror(*map(torch.tensor, (q, k, v)), plan)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), pos, window=window,
                                interpret=True)
    _close_rel(out, want)
    plain, plain_lse = decode_attention_plain(*map(torch.tensor, (q, k, v)),
                                              pos, window=window)
    _close_rel(out, plain)
    _close_rel(lse, plain_lse)


def _ssd_decode_mirror(x, b, c, dt, a, state0):
    """`ssd_decode` in plain PyTorch (fp32): the recurrence stepped token by
    token, h <- exp(dt a) h + (dt x_d) B_k and y_d = sum_k C_k h_dk."""
    h = state0.float()
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t].float()                              # (B, H)
        decay = torch.exp(dtt * a.float())
        xd = dtt[..., None] * x[:, t].float()               # (B, H, hd)
        h = decay[..., None, None] * h + xd[..., None] * \
            b[:, t, None, None, :].float()
        ys.append(torch.einsum("bhdn,bn->bhd", h, c[:, t].float()))
    return h, torch.stack(ys, dim=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,hd,n", [
    (1, 1, 4, 16, 8),                     # decode: one token
    (1, 1, 6, 64, 64),                    # zamba2-7b's head, fewer heads
    (2, sc.DECODE_T_MAX, 3, 16, 8),       # the decode kernel's longest scan
    (1, 5, 2, 20, 12),                    # ragged rows and N
])
def test_ssd_decode_arithmetic_matches_reference(b, t, h, hd, n, dtype):
    ins = _ssd_inputs(b, t, h, hd, n, seed=b + t + h + hd)
    if dtype == "bfloat16":                  # bf16 inputs, compared in f32
        ins = tuple(torch.tensor(u).bfloat16().float().numpy() for u in ins)
    plan = sc.plan_ssd(b, t, h, hd, n, 4 if dtype == "float32" else 2,
                       (0, 0))
    # both variants step the same arithmetic; they differ in their loads
    assert plan.variant in (sc.DECODE_VECTOR, sc.DECODE_SCALAR)
    sf, y = _ssd_decode_mirror(*map(torch.tensor, ins))
    sf_k, y_k = jax_ssd_chunk_scan(*map(jnp.asarray, ins), interpret=True)
    _close_rel(y, y_k)
    _close_rel(sf, sf_k)
    sf_r, y_r = jax_ssd_scan_ref(*map(jnp.asarray, ins))
    _close_rel(y, y_r)
    _close_rel(sf, sf_r)
    # and the port's plain version, which the card compares with
    sf_p, y_p = ssd_chunk_scan_plain(*map(torch.tensor, ins))
    _close_rel(y, y_p)
    _close_rel(sf, sf_p)


# ------------------------------------------------------ unit lowerings
ATTN = AttnOp(H=8, S=512, KV=4, hd=16)
SSM = SSMOp(T=64, H=8, hd=8, N=16)
SSM_DECODE = SSMOp(T=1, H=8, hd=8, N=16)


def _unit_io(op, seed):
    """The reference's draw for a unit: (x, w) as numpy."""
    rng = np.random.default_rng(seed)
    ent = registry.get(registry.op_kind(op))
    x = rng.standard_normal(ent.input_shape(op)).astype(np.float32)
    return x, ent.init_weight(op, rng)


def _jax_op(op):
    return (JaxAttnOp(**vars(op)) if isinstance(op, AttnOp)
            else JaxSSMOp(**vars(op)))


@pytest.mark.parametrize("op", [ATTN, AttnOp(H=8, S=300, KV=2, hd=16,
                                              window=64), SSM, SSM_DECODE],
                         ids=["attn", "attn-window", "ssm", "ssm-decode"])
def test_unit_lowerings_match_the_reference_oracle(op):
    x, w = _unit_io(op, seed=11)
    jop = _jax_op(op)
    ref_oracle = (attention_unit_oracle if isinstance(op, AttnOp)
                  else ssm_unit_oracle)
    want = _np(ref_oracle(jnp.asarray(x), jnp.asarray(w), jop))
    low = registry.get_lowering(registry.op_kind(op))
    tol = ATTN_TOL if isinstance(op, AttnOp) else SSD_TOL
    for fn in (low.kernel, low.oracle):
        got = fn(torch.tensor(x), torch.tensor(w), op)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), want, **tol)


def test_unpack_params_matches_the_reference():
    _, w = _unit_io(SSM, seed=12)
    got = _unpack_params(torch.tensor(w), SSM)
    want = jax_unpack_params(jnp.asarray(w), _jax_op(SSM))
    for g, r in zip(got, want):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), _np(r), **SAME_TOL)
    dt, a = _np(got[2]), _np(got[3])
    assert (dt > 0.05).all() and (dt < 0.25).all() and (a <= -0.1).all()


# ---------------------------------------------------- split lowerings
def _split_inputs(op, seed):
    x, w = _unit_io(op, seed)
    return torch.tensor(x), torch.tensor(w)


def _as_group_local(x, c_fast):
    """`x` as a producer's group-local result split at channel c_fast."""
    return GroupLocal((x[..., :c_fast], x[..., c_fast:]), (None, None),
                      SplitPlan(c_out=x.shape[-1], c_fast=c_fast))


@pytest.mark.parametrize("kind,axis,op,n_fast,tol", [
    ("attention", "head", ATTN, 2, SAME_TOL),
    ("attention", "head", ATTN, 6, SAME_TOL),
    ("attention", "kv-block", ATTN, 128, ATTN_TOL),
    ("attention", "kv-block", ATTN, 384, ATTN_TOL),
    ("ssm", "ssm-state", SSM, 3, SAME_TOL),
    ("ssm", "ssm-state", SSM_DECODE, 5, SAME_TOL),
])
def test_split_lowering_on_two_cpu_groups_matches_unsplit(kind, axis, op,
                                                          n_fast, tol):
    x, w = _split_inputs(op, seed=n_fast)
    groups = coexec_groups("cpu")
    want = _np(registry.get_lowering(kind).kernel(x, w, op))
    low = registry.get_split_lowering(kind, axis)
    split, packed = low.pack(w, op, n_fast, groups)
    gathered = low.run(x, packed, split, groups, op, n_fast)
    np.testing.assert_allclose(_np(gathered), want, **tol)
    # chained: the input is a producer's group-local result
    x_local = _as_group_local(x, 3 * x.shape[-1] // 4)
    chained = low.run(x_local, packed, split, groups, op, n_fast,
                      gather=False, x_plan=x_local.split)
    spec = registry.axis_spec(kind, axis)
    if not spec.stackable:                  # merged and materialized
        assert isinstance(chained, torch.Tensor)
    else:
        assert isinstance(chained, GroupLocal)
        assert chained.split.c_fast == n_fast * spec.unit_channels(op)
        assert chained.shape == tuple(want.shape)
        chained = torch.cat(chained.parts, dim=-1)
    np.testing.assert_allclose(_np(chained), _np(gathered), **SAME_TOL)


# --------------------------------------------------- split validation
_VALIDATION_CASES = [
    (ATTN, "head", n) for n in range(-1, 10)] + [
    (AttnOp(H=4, S=512, KV=1, hd=16), "head", 2),       # one GQA group
    (SSMOp(T=64, H=8, hd=12, N=16), "ssm-state", 4),    # 12 % 8 != 0
    (SSM, "ssm-state", 4), (SSM, "ssm-state", -1), (SSM, "ssm-state", 9),
    (SSMOp(T=1, H=1, hd=8, N=16), "ssm-state", 1),
    (AttnOp(H=8, S=128, KV=4, hd=16), "kv-block", 64),  # S < KV_BLOCK_MIN_S
    (AttnOp(H=8, S=512, KV=4, hd=16, window=256), "kv-block", 256),
    (ATTN, "kv-block", 256), (ATTN, "kv-block", 100), (ATTN, "kv-block", 0),
    (ATTN, "kv-block", 513),
    (AttnOp(H=32, S=4096, KV=32, hd=112), "kv-block", 3072),
    (AttnOp(H=32, S=4096, KV=32, hd=112), "kv-block", 3000),
]


@pytest.mark.parametrize("op,axis,n_fast", _VALIDATION_CASES)
def test_validate_axis_split_rejects_what_the_reference_rejects(op, axis,
                                                                n_fast):
    try:
        jax_registry.validate_axis_split(_jax_op(op), axis, n_fast)
        ref_err = None
    except ValueError as e:
        ref_err = str(e)
    if ref_err is None:
        assert registry.validate_axis_split(op, axis, n_fast).axis == axis
    else:
        with pytest.raises(ValueError) as got:
            registry.validate_axis_split(op, axis, n_fast)
        assert str(got.value) == ref_err


def test_every_kind_has_a_lowering_and_its_axes_split_lowerings():
    for kind in registry.kinds():
        low = registry.get_lowering(kind)
        assert callable(low.kernel) and callable(low.oracle)
    for kind, axis in (("attention", "head"), ("attention", "kv-block"),
                       ("ssm", "ssm-state")):
        assert registry.get_split_lowering(kind, axis).pack is not None
    with pytest.raises(KeyError):
        registry.get_split_lowering("linear", "head")
