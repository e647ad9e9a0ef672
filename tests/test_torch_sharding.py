"""The port's meshes, sharding rules and ambient mesh against the
reference's, on the CPU.

`sanitize`, `param_spec`, `batch_spec` and `cache_spec` give the
reference's specs (as tuples) for every leaf of every architecture's
reference param and cache trees (`jax.eval_shape`, published widths), on
the production meshes (16x16, 2x16x16) and the test meshes (2x4, 2x2x2).
One mesh object, the port's abstract `Mesh`, serves both packages: the
rules read only `mesh.shape[axis]` and `mesh.axis_names`.  On the port's
own per-layer trees every leaf gets a spec, and the one place the two
layouts read the rule table differently (a stacked dense FFN leaf takes
the MoE rule in the reference) is pinned.  `shard_params` on the (1, 1)
CPU mesh keeps every value and raises on an abstract mesh; the ambient
mesh nests; the MoE local dispatch equals the reference's `_moe_core` on
each batch shard (fp32, within 1e-6 of the largest |y|); the ViT-Base-32
ops are the reference's.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import vit_base_32 as jax_vit
from repro.launch.shapes import INPUT_SHAPES as JAX_SHAPES
from repro.models import build as jax_build
from repro.models import build_model as jax_build_model
from repro.models import get_config as jax_get_config
from repro.models.moe import _moe_core as jax_moe_core
from repro.sharding import ctx as jax_ctx
from repro.sharding import rules as jax_rules

from repro_torch.configs import vit_base_32
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, make_test_mesh)
from repro_torch.launch.steps import params_specs
from repro_torch.models import ARCH_IDS, build, build_model, get_config
from repro_torch.models import moe
from repro_torch.sharding import ctx
from repro_torch.sharding import rules
from repro_torch.sharding.rules import (batch_spec, param_shardings,
                                        param_spec, sanitize, shard_params)

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "2x4": make_test_mesh(),
          "2x2x2": make_test_mesh(multi_pod=True)}


def _meta(leaf):
    """A jax ShapeDtypeStruct as a storage-less torch tensor of its shape
    (the rules read shape and ndim only)."""
    return torch.empty(leaf.shape, device="meta")


def _ref_by_path(tree, spec_fn):
    """{path string: tuple(spec)} over a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax_rules._path_str(path): tuple(spec_fn(path, leaf))
            for path, leaf in flat}


def _port_by_path(tree, spec_fn):
    """{path string: tuple(spec)} over the same tree as meta tensors."""
    out = {}
    rules._with_path(lambda path, leaf: out.__setitem__(
        rules._path_str(path), tuple(spec_fn(path, leaf))),
        jax.tree.map(_meta, tree))
    return out


@functools.lru_cache(maxsize=None)
def reference_trees(arch):
    """The reference's param tree and its decode_32k and long_500k cache
    trees at published widths, abstract."""
    _, model = jax_build(arch)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    caches = {name: jax.eval_shape(lambda s=JAX_SHAPES[name]: model.init_cache(
        s.global_batch, s.seq_len)) for name in ("decode_32k", "long_500k")}
    return params, caches


# ------------------------------------------------------------------ meshes
def test_meshes_are_the_references():
    assert {k: (m.axis_names, m.shape, m.devices is None)
            for k, m in MESHES.items()} == {
        "16x16": (("data", "model"), {"data": 16, "model": 16}, True),
        "2x16x16": (("pod", "data", "model"),
                    {"pod": 2, "data": 16, "model": 16}, True),
        "2x4": (("data", "model"), {"data": 2, "model": 4}, True),
        "2x2x2": (("pod", "data", "model"),
                  {"pod": 2, "data": 2, "model": 2}, True)}
    assert {k: m.name for k, m in MESHES.items()} == {k: k for k in MESHES}
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),) and host.size == 1
    with pytest.raises(ValueError):
        Mesh(("data", "model"), (2, 2), (torch.device("cpu"),))


# ----------------------------------------------------------- spec parity
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sanitize_and_batch_spec_are_the_references(mesh):
    m = MESHES[mesh]
    specs = [("model", None), (None, "model"), ("data", "model"),
             (("pod", "data"), None), ("model", "data", None)]
    shapes = [(20, 64), (32, 64), (4, 128), (1, 16), (16, 1), (64, 64, 3),
              (2, 2, 2), (8, 6, 4)]
    for spec in specs:
        for shape in shapes:
            if any(isinstance(a, tuple) for a in spec) and "pod" not in \
                    m.shape:
                continue
            want = tuple(jax_rules.sanitize(spec, shape, m))
            assert sanitize(spec, shape, m) == want, (spec, shape)
    for b in (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512):
        assert batch_spec(b, m) == tuple(jax_rules.batch_spec(b, m)), b


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references(arch, mesh):
    """Every leaf of the reference's param tree (stacked layers) gets the
    reference's spec from the port's rule table."""
    m = MESHES[mesh]
    params, _ = reference_trees(arch)
    want = _ref_by_path(params, lambda p, l: jax_rules.param_spec(p, l, m))
    got = _port_by_path(params, lambda p, l: param_spec(p, l, m))
    assert got == want


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_are_the_references(arch, mesh):
    """Every leaf of the reference's decode_32k cache (batch 128) and
    long_500k cache (batch 1, the sequence on data) gets the reference's
    spec."""
    m = MESHES[mesh]
    _, caches = reference_trees(arch)
    for name, seq_shard in (("decode_32k", False), ("long_500k", True)):
        b = JAX_SHAPES[name].global_batch
        want = _ref_by_path(caches[name], lambda p, l: jax_rules.cache_spec(
            p, l, m, batch=b, seq_shard=seq_shard))
        got = _port_by_path(caches[name], lambda p, l: rules.cache_spec(
            p, l, m, batch=b, seq_shard=seq_shard))
        assert got == want, name


# ------------------------------------------------- the port's own layout
@functools.lru_cache(maxsize=None)
def port_params(arch):
    cfg, model = build(arch)
    return params_specs(cfg, model, mode=FakeTensorMode())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_port_leaf_gets_a_sanitized_spec(arch):
    """The port's per-layer tree at published widths: every leaf gets a
    spec of its rank on the production mesh, each named axis divides its
    dimension, and the big matrices are sharded."""
    m = MESHES["16x16"]
    params = port_params(arch)
    shardings = param_shardings(params, m)
    pairs = list(zip(tree_leaves(params), tree_leaves(shardings)))
    assert pairs and all(len(sh.spec) == leaf.ndim for leaf, sh in pairs)
    for leaf, sh in pairs:
        for dim, axis in zip(leaf.shape, sh.spec):
            assert axis is None or dim % m.shape[axis] == 0
    big = [sh for leaf, sh in pairs if leaf.numel() >= 2 ** 24]
    assert big and all(any(a is not None for a in sh.spec) for sh in big)


@pytest.mark.parametrize("arch,stacked,want_ref", [
    ("codeqwen15_7b", (32, 4096, 13440), ("model", "data", None)),
    ("llama3_405b", (126, 16384, 53248), (None, "data", None))])
def test_a_stacked_dense_ffn_takes_the_moe_rule_in_the_reference(
        arch, stacked, want_ref):
    """The reference's MoE rules (anchor rank 3) precede the dense FFN
    rules, so its stacked dense `w_gate` takes the expert spec; the
    port's per-layer leaf takes the dense one."""
    m = MESHES["16x16"]
    params, _ = reference_trees(arch)
    ref_leaf = params["pattern"][0]["ffn"]["w_gate"]
    assert ref_leaf.shape == stacked
    ref = _ref_by_path(params, lambda p, l: jax_rules.param_spec(p, l, m))
    assert ref["pattern/0/ffn/w_gate"] == want_ref
    port = port_params(arch)["pattern"][0][0]["ffn"]["w_gate"]
    assert tuple(port.shape) == stacked[1:]
    got = param_spec(("pattern", 0, 0, "ffn", "w_gate"), port, m)
    assert got == ("data", "model")


# ------------------------------------------------------------ placement
def test_shard_params_on_the_host_mesh_keeps_every_value():
    cfg = get_config("deepseek_v2_lite").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    mesh = make_host_mesh("cpu")
    placed = shard_params(params, param_shardings(params, mesh))
    pairs = list(zip(tree_leaves(placed), tree_leaves(params)))
    assert all(a.device == torch.device("cpu") and a.dtype == b.dtype
               and torch.equal(a, b) for a, b in pairs)
    for abstract in (MESHES["2x4"], MESHES["16x16"]):
        with pytest.raises(RuntimeError, match=f"= {abstract.size} devices;"
                           " this process runs on 1"):
            shard_params(params, param_shardings(params, abstract))


def test_activation_mesh_nests_and_restores():
    assert ctx.current_mesh() is None and ctx.batch_axes() == ("data",)
    outer, inner = MESHES["16x16"], MESHES["2x16x16"]
    with ctx.activation_mesh(outer):
        assert ctx.current_mesh() is outer
        with ctx.activation_mesh(inner):
            assert ctx.current_mesh() is inner
            x = torch.ones(3)
            assert ctx.constrain(x, "data") is x
        assert ctx.current_mesh() is outer
    assert ctx.current_mesh() is None


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_batch_axes_are_the_references(mesh):
    m = MESHES[mesh]
    with ctx.activation_mesh(m), jax_ctx.activation_mesh(m):
        assert ctx.batch_axes() == jax_ctx.batch_axes()


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("mesh,b,t", [("2x4", 2, 16), ("2x2x2", 4, 8),
                                      ("2x4", 3, 10)])
def test_moe_local_dispatch_is_the_references_core_per_shard(mesh, b, t):
    """Under a mesh with batch shards, `moe_local_dispatch` runs the core
    on each contiguous slice of the flat tokens with the per-shard
    capacity, and the aux loss is their mean: the reference's
    `shard_map`, whose body is `_moe_core`."""
    cfg = dataclasses.replace(get_config("deepseek_v2_lite").reduced(),
                              dtype="float32", moe_local_dispatch=True)
    jcfg = dataclasses.replace(jax_get_config("deepseek_v2_lite").reduced(),
                               dtype="float32", moe_local_dispatch=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    # the first repeat of the stacked MoE layer
    ref = jax.tree.map(lambda a: np.asarray(a)[0],
                       jparams["pattern"][0]["ffn"])
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref)
    x = np.random.default_rng(5).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    m = MESHES[mesh]
    shards = int(np.prod([m.shape[a] for a in ("pod", "data")
                          if a in m.shape]))
    n, k, e = b * t, cfg.experts_per_token, cfg.n_experts
    assert n % shards == 0 and (n // shards) * k >= e
    cap = max(1, int(1.25 * (n // shards) * k / e))
    parts = [jax_moe_core(jax.tree.map(jax.numpy.asarray, ref),
                          jax.numpy.asarray(xs), jcfg, cap)
             for xs in np.split(x.reshape(n, -1), shards)]
    want_y = np.concatenate([np.asarray(y) for y, _ in parts])
    want_aux = float(np.mean([float(a) for _, a in parts]))
    with ctx.activation_mesh(m):
        y, aux = moe.moe_layer(p, torch.from_numpy(x), cfg)
    tol = 1e-6 * float(np.abs(want_y).max())
    assert np.abs(y.reshape(n, -1).numpy() - want_y).max() <= tol
    assert abs(float(aux) - want_aux) <= 1e-6 * abs(want_aux)
    # with no mesh the flag falls through to the unsharded branch
    plain = dataclasses.replace(cfg, moe_local_dispatch=False)
    y0, aux0 = moe.moe_layer(p, torch.from_numpy(x), plain)
    y1, aux1 = moe.moe_layer(p, torch.from_numpy(x), cfg)
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)


def test_vit_base_32_ops_are_the_references():
    assert [dataclasses.astuple(op) for op in vit_base_32.ALL_OPS] == [
        dataclasses.astuple(op) for op in jax_vit.ALL_OPS]
    for name in ("MLP_UP", "MLP_DOWN", "QKV", "PROJ"):
        assert dataclasses.asdict(getattr(vit_base_32, name)) == \
            dataclasses.asdict(getattr(jax_vit, name))
