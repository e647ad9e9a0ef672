"""Two-group co-execution of the port on two CPU groups.

`coexec_matmul` / `coexec_conv2d` split a node's output channels across
the groups; gathered, or chained into a split consumer through `x_plan=`,
they must match the unsplit product.  The split layout (`SplitPlan`,
`pack_weights`) matches the JAX package's on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coexec import SplitPlan as JSplitPlan
from repro.core.coexec import pack_weights as jax_pack_weights

from repro_torch.core.coexec import (GroupLocal, SplitPlan, coexec_conv2d,
                                     coexec_groups, coexec_matmul,
                                     gather_stacked, pack_weights,
                                     resolve_device, split_for_groups)
from repro_torch.core.types import ConvOp, LinearOp
from repro_torch.kernels import registry
from repro_torch.kernels.winograd_conv.ops import (conv2d_op,
                                                   crop_to_declared)


@pytest.fixture(scope="module")
def groups():
    return coexec_groups("cpu")


def _t(rng, shape, scale=1.0):
    return torch.tensor((rng.standard_normal(shape) * scale)
                        .astype(np.float32))


@pytest.mark.parametrize("c_out,c_fast", [(72, 0), (72, 24), (72, 72),
                                          (4096, 728), (100, 37)])
def test_split_layout_matches_the_reference(groups, c_out, c_fast):
    split = split_for_groups(c_out, c_fast, groups)
    ref = JSplitPlan(c_out=c_out, c_fast=c_fast, align=8)
    assert (split.c_fast, split.c_slow, split.c_pad) == \
        (ref.c_fast, ref.c_slow, ref.c_pad)
    w = np.random.default_rng(c_out + c_fast).standard_normal(
        (3, 5, c_out)).astype(np.float32)
    np.testing.assert_array_equal(
        pack_weights(torch.tensor(w), split).numpy(),
        np.asarray(jax_pack_weights(jnp.asarray(w), ref)))


# linear (L, C_in) -> (L, C_out): c_fast in {0, ragged, full}
@pytest.mark.parametrize("c_fast", [0, 20, 43, 64])
def test_coexec_matmul_gathered_and_chained_match_unsplit(groups, c_fast):
    rng = np.random.default_rng(c_fast)
    x = _t(rng, (3, 48))
    w1 = _t(rng, (48, 64), 48 ** -0.5)
    w2 = _t(rng, (64, 64), 64 ** -0.5)
    s1 = split_for_groups(64, c_fast, groups)
    s2 = split_for_groups(64, (c_fast + 24) % 65, groups)
    p1, p2 = pack_weights(w1, s1), pack_weights(w2, s2)

    y1 = coexec_matmul(x, p1, s1, groups)
    # the same products per output channel, in the same order: bit-equal
    assert torch.equal(y1, x @ w1)

    local = coexec_matmul(x, p1, s1, groups, gather=False)
    assert isinstance(local, GroupLocal) and local.shape == (3, 64)
    assert [p.shape[-1] for p in local.parts] == [s1.c_fast, s1.c_slow]
    y2 = coexec_matmul(local, p2, s2, groups, x_plan=s1)
    torch.testing.assert_close(y2, (x @ w1) @ w2, rtol=1e-6, atol=1e-6)
    assert torch.equal(gather_stacked(local), y1)


@pytest.mark.parametrize("op,c_fast", [
    (ConvOp(16, 16, 8, 24, 3, 1), 0),
    (ConvOp(16, 16, 8, 24, 3, 1), 10),
    (ConvOp(16, 16, 8, 24, 3, 1), 24),
    (ConvOp(15, 15, 8, 24, 3, 2), 16),     # odd input, floor output crop
    (ConvOp(32, 32, 32, 128, 3, 1), 40),   # Winograd-eligible
])
def test_coexec_conv2d_gathered_and_chained_match_unsplit(groups, op,
                                                          c_fast):
    rng = np.random.default_rng(op.H_in + c_fast)
    x = _t(rng, (1, op.H_in, op.W_in, op.C_in))
    w = _t(rng, (op.K, op.K, op.C_in, op.C_out), (op.K * op.K * op.C_in) ** -0.5)
    nxt = ConvOp(op.H_out, op.W_out, op.C_out, op.C_out, 3, 1)
    w2 = _t(rng, (3, 3, op.C_out, op.C_out), (9 * op.C_out) ** -0.5)
    s1 = split_for_groups(op.C_out, c_fast, groups)
    s2 = split_for_groups(nxt.C_out, op.C_out // 3, groups)
    p1, p2 = pack_weights(w, s1), pack_weights(w2, s2)

    want1 = crop_to_declared(conv2d_op(x, w, op), op)
    y1 = coexec_conv2d(x, p1, s1, groups, op=op)
    assert tuple(y1.shape) == (1, op.H_out, op.W_out, op.C_out)
    # each output channel is computed alone, by the algorithm of `op`
    torch.testing.assert_close(y1, want1, rtol=1e-6, atol=1e-6)

    local = coexec_conv2d(x, p1, s1, groups, op=op, gather=False)
    assert local.shape == (1, op.H_out, op.W_out, op.C_out)
    y2 = coexec_conv2d(local, p2, s2, groups, op=nxt, x_plan=s1)
    want2 = crop_to_declared(conv2d_op(want1, w2, nxt), nxt)
    torch.testing.assert_close(y2, want2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op,c_fast", [
    (LinearOp(3, 64, 64), 20),
    (LinearOp(3, 64, 64), 43),
    (ConvOp(16, 16, 24, 24, 3, 1), 10),
    (ConvOp(32, 32, 128, 128, 3, 1), 40),  # Winograd-eligible
], ids=["linear-20", "linear-43", "conv-10", "conv-winograd-40"])
def test_channel_split_lowering_is_pack_weights_and_coexec(groups, op,
                                                           c_fast):
    """The registry's ("linear" | "conv", "channel") split lowering packs
    as `split_for_groups` + `pack_weights` and runs as `coexec_matmul` /
    `coexec_conv2d`, group-local, gathered and chained, bit for bit; the
    planner is offered no "channel" axis."""
    unit = registry.op_kind(op)
    assert all(a.axis != "channel" for a in registry.axes_for(op))
    low = registry.get_split_lowering(unit, "channel")
    rng = np.random.default_rng(c_fast)
    w = _t(rng, registry.get(unit).weight_shape(op), 0.1)
    x = _t(rng, (1,) + tuple(registry.get(unit).input_shape(op))
           if unit == "conv" else registry.get(unit).input_shape(op))
    split, packed = low.pack(w, op, c_fast, groups)
    want = split_for_groups(op.C_out, c_fast, groups)
    assert split == want and torch.equal(packed, pack_weights(w, want))

    def ref(x_in, gather, x_plan=None):
        if unit == "linear":
            return coexec_matmul(x_in, packed, split, groups, gather=gather,
                                 x_plan=x_plan)
        return coexec_conv2d(x_in, packed, split, groups, op=op,
                             gather=gather, x_plan=x_plan)

    def run(x_in, gather, x_plan=None):
        return low.run(x_in, packed, split, groups, op, c_fast,
                       gather=gather, x_plan=x_plan, launch=None)

    assert torch.equal(run(x, True), ref(x, True))
    local, ref_local = run(x, False), ref(x, False)
    assert isinstance(local, GroupLocal) and local.split == split
    assert all(torch.equal(a, b)
               for a, b in zip(local.parts, ref_local.parts))
    # chained into the same node again (C_in == C_out)
    assert torch.equal(run(local, True, split), ref(ref_local, True, split))


def test_chaining_needs_the_producers_split(groups):
    rng = np.random.default_rng(3)
    x = _t(rng, (2, 16))
    s = split_for_groups(16, 8, groups)
    p = pack_weights(_t(rng, (16, 16)), s)
    local = coexec_matmul(x, p, s, groups, gather=False)
    with pytest.raises(TypeError):
        coexec_matmul(local, p, s, groups)             # no x_plan
    with pytest.raises(TypeError):
        coexec_matmul(x, p, s, groups, x_plan=s)       # plain x, x_plan
    with pytest.raises(ValueError):
        coexec_matmul(local, p, s, groups,
                      x_plan=SplitPlan(c_out=16, c_fast=4))


def test_groups_on_the_cpu_and_the_cuda_default():
    assert len(coexec_groups("cpu", n=1)) == 1
    assert all(g.stream is None for g in coexec_groups("cpu"))
    with pytest.raises(ValueError):
        coexec_groups("cpu", n=3)
    with pytest.raises(ValueError):
        split_for_groups(8, 4, coexec_groups("cpu", n=1))
    if not torch.cuda.is_available():
        # the default device is CUDA, and nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            coexec_groups()
