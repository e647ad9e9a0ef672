"""The port's kernel autotuner on the CPU, held against the reference's.

The Hopper launch table (`repro_torch.kernels.tiles`) and the wrappers'
`launch=`; the tune cache's digest against `repro.runtime.autotune.TuneKey`
and its cold, warm, corrupt and cross-instance lookups; `verify_tune_entry`
on the reference's entries and the port's, with the reference's rule ids;
the tile-aware predictors and `predictor_checksum`'s `/tiles` tag against
the reference's; `compile(tune=True)` with the measurement injected (the
real one needs the card, `tests/test_torch_cuda.py`): keys, warm hits,
documents, the sidecar and the launches that reach the kernels; a
reference-tuned VGG16 artifact in the port; and the CLI with jax and
`repro` blocked, refusing on a host without CUDA.
"""
import copy
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import repro
import repro.runtime.autotune as jax_at
from repro.analysis import errors as jax_errors
from repro.analysis import verify_plan as jax_verify_plan
from repro.analysis import verify_tune_entry as jax_verify_tune_entry
from repro.core.predictor import sample_linear_ops as jax_sample_linear_ops
from repro.core.predictor.features import (feature_names as jax_feature_names,
                                           tile_feature_names as
                                           jax_tile_feature_names,
                                           tile_features as jax_tile_features)
from repro.core.predictor.train import train_predictor as jax_train
from repro.core.types import ConvOp as JaxConvOp
from repro.core.types import LinearOp as JaxLinearOp
from repro.kernels import registry as jax_registry
from repro.kernels import tiles as jax_tiles
from repro.runtime.executor import PlanExecutor as JaxPlanExecutor
from repro.runtime.plan import predictor_checksum as jax_checksum

import repro_torch
import repro_torch.runtime.autotune as at
from repro_torch.analysis import VerificationError, verify_path
from repro_torch.analysis import verify_tune_entry
from repro_torch.core.predictor import sample_linear_ops
from repro_torch.core.predictor.features import (feature_names,
                                                 tile_feature_names,
                                                 tile_features)
from repro_torch.core.predictor.train import train_predictor
from repro_torch.core.types import AttnOp, ConvOp, LinearOp, SSMOp
from repro_torch.kernels import registry, tiles
from repro_torch.runtime.autotune import (TuneCache, TuneKey,
                                          annotate_plan_tiles, autotune,
                                          sidecar_path, tune_cache_version)
from repro_torch.runtime.plan import predictor_checksum

from test_torch_support import blocked_cli, small_units, to_port

#: one op per kind on the port's path, each with a launch grid to search
OPS = {
    "linear": LinearOp(L=1, C_in=3584, C_out=1472),        # the GEMV
    "linear tiled": LinearOp(L=64, C_in=256, C_out=200),    # M > 8
    "conv": ConvOp(H_in=32, W_in=32, C_in=32, C_out=128),   # Winograd
    "attention": AttnOp(H=8, S=512, KV=4, hd=16),
    "ssm": SSMOp(T=64, H=4, hd=8, N=16),
}

#: the card the injected measurement claims
CARD = ("NVIDIA H100 80GB HBM3", "cuda")

SMALL = dict(samples=60, estimators=8)


def _kind(name):
    return name.split()[0]


# ------------------------------------------------------ the launch table

def test_check_tile_and_check_chunk_are_the_reference_copies():
    cases = [("bm", None, 128, 16, 8), ("bm", 16, 128, 16, 8),
             ("bm", 12, 128, 16, 8), ("bs", 100, 512, 300, 1, 128),
             ("bn", 1024, 128, 256, 128), ("bm", -8, 128, 16, 8)]
    for args in cases:
        got = want = None
        try:
            got = tiles.check_tile(*args)
        except ValueError as e:
            got = str(e)
        try:
            want = jax_tiles.check_tile(*args)
        except ValueError as e:
            want = str(e)
        assert got == want
    for args in [("chunk", None, 256, 64), ("chunk", 48, 256, 64),
                 ("chunk", 32, 256, 64), ("chunk", 0, 256, 64)]:
        try:
            got = tiles.check_chunk(*args)
        except ValueError as e:
            got = str(e)
        try:
            want = jax_tiles.check_chunk(*args)
        except ValueError as e:
            want = str(e)
        assert got == want
    assert tiles.round_up(17, 8) == jax_tiles.round_up(17, 8) == 24


def test_the_launch_table_imports_nothing_of_the_port():
    """Like the reference's `kernels/tiles.py`: the kernel modules import
    the table, never the other way round."""
    import ast
    tree = ast.parse(open(tiles.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "dataclasses", "typing"}, names


@pytest.mark.parametrize("name", sorted(OPS))
def test_grids_start_at_the_default_and_hold_only_legal_launches(name):
    op = OPS[name]
    spec = tiles.launch_spec(_kind(name))
    extents = registry.launch_extents(op)
    for preserve in (True, False):
        grid = spec.configs(extents, preserve_numerics=preserve)
        assert grid[0] == spec.default() and grid[0].label() == "default"
        assert len(set(grid)) == len(grid)
        for launch in grid:
            assert spec.validate(launch, extents) is launch
            if preserve:          # reduction-axis params stay the planner's
                assert not any(spec.param(n).reduction
                               for n, _ in launch.values)


def test_preserving_grids_collapse_where_only_reductions_are_tuned():
    """As the reference's attention grid does: the GEMV's splits, the
    attention runs and the SSD chunk regroup sums, so only the tiled
    products (Winograd, M > 8) have output-tiling candidates."""
    for name in ("linear", "attention", "ssm"):
        spec = tiles.launch_spec(_kind(name))
        ext = registry.launch_extents(OPS[name])
        assert spec.configs(ext) == [spec.default()]
        assert len(spec.configs(ext, preserve_numerics=False)) > 1
    conv = tiles.launch_spec("conv").configs(
        registry.launch_extents(OPS["conv"]))
    assert [c.label() for c in conv] == [
        "default", "bm64/bn128", "bm128/bn64", "bm128/bn128"]
    tiled = tiles.launch_spec("linear").configs(
        registry.launch_extents(OPS["linear tiled"]))
    assert [c.label() for c in tiled] == [
        "default", "bm64/bn64", "bm64/bn128"]
    # the tiled product's K split regroups its sum too: searched only
    # without preserve_numerics (K = 256 is four 64-row steps)
    relaxed = tiles.launch_spec("linear").configs(
        registry.launch_extents(OPS["linear tiled"]), preserve_numerics=False)
    assert sorted({c.get("splits") for c in relaxed} - {None}) == [1, 2, 4]
    # a direct conv launches no kernel of the port: nothing to tune
    direct = ConvOp(H_in=8, W_in=8, C_in=3, C_out=16)
    assert registry.launch_extents(direct) == {}
    assert tiles.launch_spec("conv").configs({}) == [tiles.Launch("conv")]


def test_the_table_and_the_kernel_planners_share_their_facts():
    import importlib
    da, sm, sc, wc = (importlib.import_module(f"repro_torch.kernels.{m}")
                      for m in ("decode_attention.decode_attention",
                                "split_matmul.split_matmul",
                                "ssd_chunk.ssd_chunk",
                                "winograd_conv.winograd_conv"))
    assert wc.TILES is tiles.HADAMARD_TILES
    assert sm.MAX_GEMV_ROWS == tiles.MAX_GEMV_ROWS
    assert sm.GEMM_BK == tiles.GEMM_BK
    assert set(sm.GEMM_BLOCKS) == {(bm, bn) for bm in tiles.GEMM_EDGES
                                   for bn in tiles.GEMM_EDGES}
    assert da.TILE == tiles.ATTN_TILE
    assert (sc.CHUNK, sc.DECODE_T_MAX) == (tiles.SSD_CHUNK,
                                           tiles.SSD_DECODE_T_MAX)
    assert sc.smem_bytes is tiles.ssd_smem_bytes
    assert sc.HEAD_GROUPS[0] == tiles.SSD_MAX_HEADS
    # every tile's resident blocks fit an SM's 228 KB together: a ring of
    # 3 fp32 K slices of 16 rows of A and of B per block
    for (bm, bn), resident in tiles.HADAMARD_TILES.items():
        assert 3 * 16 * (bm + bn) * 4 * resident <= 228 * 1024


def test_explicit_launches_fix_what_the_planners_pick():
    from repro_torch.kernels.decode_attention.decode_attention import (
        plan_attention)
    from repro_torch.kernels.split_matmul.split_matmul import (TILED,
                                                               plan_launch)
    from repro_torch.kernels.ssd_chunk.ssd_chunk import CHUNKED, plan_ssd
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        plan_hadamard)
    lin = tiles.launch_spec("linear")
    plan = plan_launch(1, 3584, 1472, 0, 1472, 4, 0, 132, 8,
                       lin.config(splits=8))
    assert (plan.splits, plan.k_chunk) == (8, 448)
    assert plan_launch(1, 3584, 1472, 0, 1472, 4, 0, 132, 8) == \
        plan_launch(1, 3584, 1472, 0, 1472, 4, 0, 132, 8, lin.default())
    tiled = plan_launch(64, 256, 200, 0, 200, 4, 0, 132, 1,
                        lin.config(bm=128, bn=64))
    assert (tiled.variant, tiled.mt, tiled.tile, tiled.col_tiles) == \
        (TILED, 128, 64, 4)
    default = plan_launch(64, 256, 200, 0, 200, 4, 0, 132, 1)
    assert (default.mt, default.tile) == (64, 64)
    # a named block keeps the planner's split (two chunks of two 64-row
    # steps); named splits keep the planner's block
    assert (tiled.splits, tiled.k_chunk) == (default.splits,
                                             default.k_chunk) == (2, 128)
    four = plan_launch(64, 256, 200, 0, 200, 4, 0, 132, 1,
                       lin.config(splits=4))
    assert (four.mt, four.tile, four.splits, four.k_chunk) == (64, 64, 4, 64)
    had = plan_hadamard(16, 256, 32, 128, 4, (0, 0, 0), 132,
                        tiles.launch_spec("conv").config(bm=64, bn=128))
    assert (had.bm, had.bn, had.grid) == (64, 128, (1, 4, 16))
    att = plan_attention(0, 511, 4, 2, 16, 4, 0, 0, 132 * 3, run_tiles=2)
    assert (att.run_tiles, att.nsplit) == (2, 8)
    ssd = plan_ssd(1, 64, 4, 8, 16, 4, (0, 0), chunk=16)
    assert (ssd.variant, ssd.chunk) == (CHUNKED, 16)


@pytest.mark.parametrize("case", [
    ("split_matmul GEMV bm", "linear"), ("split_matmul inexact splits",
                                         "linear"),
    ("split_matmul X stage", "linear"), ("split_matmul bm alone", "linear"),
    ("split_matmul bm 96", "linear"),
    ("split_matmul tiled inexact splits", "linear"),
    ("hadamard 64x64", "conv"),
    ("hadamard bm alone", "conv"), ("hadamard over extent", "conv"),
    ("attention run_tiles", "attention"), ("attention kind", "attention"),
    ("ssd chunk at decode", "ssm"), ("ssd chunk smem", "ssm"),
    ("ssd unknown", "ssm")], ids=lambda c: c[0] if isinstance(c, tuple)
    else c)
def test_illegal_explicit_launches_raise_in_every_wrapper(case):
    """Validated, never clamped: on CPU tensors too, before the plain
    version runs."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.split_matmul import split_matmul
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.kernels.winograd_conv import hadamard_matmul
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    label, _ = case
    calls = {
        "split_matmul GEMV bm": lambda: split_matmul(
            r(1, 10), r(10, 40), 0, 40, launch={"bm": 64, "bn": 64}),
        "split_matmul inexact splits": lambda: split_matmul(
            r(1, 10), r(10, 40), 0, 40, launch={"splits": 6}),
        "split_matmul X stage": lambda: split_matmul(
            r(8, 60000), r(60000, 8), 0, 8, launch={"splits": 1}),
        "split_matmul bm alone": lambda: split_matmul(
            r(16, 10), r(10, 40), 0, 40, launch={"bm": 64}),
        "split_matmul bm 96": lambda: split_matmul(
            r(100, 10), r(10, 40), 0, 40, launch={"bm": 96, "bn": 64}),
        # K = 300 is five 64-row steps: chunks of two make three splits
        "split_matmul tiled inexact splits": lambda: split_matmul(
            r(16, 300), r(300, 40), 0, 40, launch={"splits": 4}),
        "hadamard 64x64": lambda: hadamard_matmul(
            r(16, 100, 8), r(16, 8, 100), launch={"bm": 64, "bn": 64}),
        "hadamard bm alone": lambda: hadamard_matmul(
            r(16, 100, 8), r(16, 8, 100), launch={"bm": 128}),
        "hadamard over extent": lambda: hadamard_matmul(
            r(16, 30, 8), r(16, 8, 100), launch={"bm": 128, "bn": 128}),
        "attention run_tiles": lambda: decode_attention(
            r(4, 8), r(64, 2, 8), r(64, 2, 8), 63, launch={"run_tiles": 3}),
        "attention kind": lambda: decode_attention(
            r(4, 8), r(64, 2, 8), r(64, 2, 8), 63,
            launch=tiles.launch_spec("ssm").config(chunk=8)),
        "ssd chunk at decode": lambda: ssd_chunk_scan(
            *_ssd_operands(g, t=4), launch={"chunk": 2}),
        "ssd chunk smem": lambda: ssd_chunk_scan(
            *_ssd_operands(g, t=512, hd=64, n=64), launch={"chunk": 256}),
        "ssd unknown": lambda: ssd_chunk_scan(
            *_ssd_operands(g, t=64), launch={"bs": 16}),
    }
    with pytest.raises(ValueError, match="launch"):
        calls[label]()


def _ssd_operands(g, t, h=2, hd=8, n=16):
    r = lambda *s: torch.randn(s, generator=g)
    return (r(1, t, h, hd), r(1, t, n) / n ** 0.5, r(1, t, n) / n ** 0.5,
            0.05 + 0.2 * torch.sigmoid(r(1, t, h)), -(0.1 + r(h).abs()),
            r(1, h, hd, n) / n ** 0.5)


def test_legal_launches_run_the_plain_versions_on_the_cpu():
    """On CPU tensors a legal launch changes nothing but the SSD scan's
    chunking, which its plain version follows (tolerance-exact)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.kernels.split_matmul import split_matmul
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(1, 300, generator=g), torch.randn(300, 50, generator=g)
    assert torch.equal(split_matmul(x, w, 0, 50, launch={"splits": 4}),
                       split_matmul(x, w, 0, 50))
    ops = _ssd_operands(g, t=64)
    base = ssd_chunk_scan(*ops)
    for chunk in (8, 16, 64):
        got = ssd_chunk_scan(*ops, launch={"chunk": chunk})
        for a, b in zip(got, base):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_clamp_fits_a_side_and_falls_back_to_the_planner():
    conv = tiles.launch_spec("conv")
    wide = {"p": 784, "k": 256, "n": 256}
    big = conv.config(bm=128, bn=128)
    assert conv.clamp(big, {**wide, "n": 40}) == conv.config(bm=128, bn=64)
    # no 64 x 64 tile: a side too narrow for (64, 128) takes the planner's
    assert conv.clamp(conv.config(bm=64, bn=128), {**wide, "n": 40}) == \
        conv.default()
    lin = tiles.launch_spec("linear")
    assert lin.clamp(lin.config(splits=256), {"m": 1, "k": 100, "n": 8}) \
        == lin.config(splits=100)
    assert lin.clamp(lin.config(splits=6), {"m": 1, "k": 10, "n": 8}) == \
        lin.config(splits=5)           # chunks of 2 rows: 5 splits
    att = tiles.launch_spec("attention")
    assert att.clamp(att.config(run_tiles=64), {"tiles": 8}) == \
        att.config(run_tiles=8)
    ssm = tiles.launch_spec("ssm")
    assert ssm.clamp(ssm.config(chunk=64), {"t": 1, "hd": 8, "n": 16}) == \
        ssm.default()                  # the decode kernel has no chunk


# ---------------------------------------------------------- the tune key

@pytest.mark.parametrize("name", sorted(OPS))
def test_tune_key_digest_is_the_references(name):
    op = OPS[name]
    jop = jax_registry.op_from_json(registry.op_to_json(op))
    # the port's Hopper launch table has its own version (2 since the
    # tiled product's redesign, where the reference's TPU table is at 1):
    # with the version equal, the fields and the digest are the reference's
    assert TuneKey.for_op(op, *CARD).kernel_version == \
        tiles.HOPPER_KERNEL_TILE_VERSION == 2
    for fields in (dict(), dict(preserve_numerics=False)):
        port = TuneKey.for_op(op, *CARD, **fields)
        ref = dataclasses.replace(jax_at.TuneKey.for_op(jop, *CARD, **fields),
                                  kernel_version=port.kernel_version)
        assert port._canonical() == ref._canonical()
        assert port.key == ref.key
    for version in (1, 2, 7):
        port = dataclasses.replace(TuneKey.for_op(op, *CARD),
                                   kernel_version=version)
        ref = dataclasses.replace(jax_at.TuneKey.for_op(jop, *CARD),
                                  kernel_version=version)
        assert port.key == ref.key
    assert tune_cache_version() == "hopper-tune-v1.k2" != \
        jax_at.tune_cache_version()


def test_tune_cache_cold_warm_corrupt_and_cross_instance(tmp_path):
    op = OPS["conv"]
    key = TuneKey.for_op(op, *CARD)
    cache = TuneCache(tmp_path)
    assert cache.get(key) is None and cache.misses == 1
    launch = tiles.launch_spec("conv").config(bm=128, bn=64)
    path = cache.put(key, launch, [("default", 12.0),
                                   ("bm128/bn64", 10.0)])
    assert cache.get(key) == launch and cache.hits == 1
    other = TuneCache(tmp_path)                  # another process's
    assert other.get(key) == launch and other.hits == 1
    assert other.keys() == [key.key]
    doc = json.loads(path.read_text())
    for bad in ("{not json",
                json.dumps({**doc, "key": {**doc["key"], "device": "x"}}),
                json.dumps({**doc, "tile": {"bm": 64, "bn": 64}}),
                json.dumps({k: v for k, v in doc.items() if k != "kernels"})):
        path.write_text(bad)
        fresh = TuneCache(tmp_path)
        assert fresh.get(key) is None and fresh.misses == 1
    relaxed = TuneKey.for_op(op, *CARD, preserve_numerics=False)
    assert relaxed.key != key.key


def test_the_two_packages_refuse_each_others_entries(tmp_path):
    """The same fields give the same digest in both packages, so a shared
    directory can hold one file for both keys: each package refuses the
    other's entry instead of trusting it."""
    op = OPS["conv"]
    jop = jax_registry.op_from_json(registry.op_to_json(op))
    # the port's launch table is at version 2 and the reference's at 1, so
    # only a reference key of the same version shares the port's digest
    key = TuneKey.for_op(op, "host", "cpu")
    jkey = dataclasses.replace(jax_at.TuneKey.for_op(jop, "host", "cpu"),
                               kernel_version=key.kernel_version)
    assert key.key == jkey.key
    jax_at.TuneCache(tmp_path).put(
        jkey, jax_registry.tile_spec("conv").config(bm=64, bn=128, bk=256),
        [])
    assert TuneCache(tmp_path).get(key) is None
    TuneCache(tmp_path).put(key, tiles.launch_spec("conv").config(
        bm=64, bn=128), [])
    assert jax_at.TuneCache(tmp_path).get(jkey) is None


# -------------------------------------------------------------- verifier

def _jax_entry(tmp_path, op_json, tile_kw):
    jop = jax_registry.op_from_json(op_json)
    jkey = jax_at.TuneKey.for_op(jop, "host", "cpu")
    path = jax_at.TuneCache(tmp_path).put(
        jkey, jax_registry.tile_spec(op_json["kind"]).config(**tile_kw),
        [("x", 1.0)])
    return json.loads(path.read_text()), jkey.key


MUTATIONS = {
    "clean": lambda d: d,
    "no key": lambda d: {k: v for k, v in d.items() if k != "key"},
    "tile not an object": lambda d: {**d, "tile": [1]},
    "schema version": lambda d: {**d, "schema_version": 2},
    "misaligned tile": lambda d: {**d, "tile": {**d["tile"], "bm": 12}},
    "unknown param": lambda d: {**d, "tile": {**d["tile"], "bz": 4}},
    "bad op": lambda d: {**d, "key": {**d["key"],
                                      "op_json": {"kind": "pool"}}},
    "another device": lambda d: {**d, "key": {**d["key"], "device": "x"}},
    "no backend": lambda d: {**d, "key": {k: v for k, v in d["key"].items()
                                          if k != "backend"}},
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_verify_tune_entry_rules_are_the_references(tmp_path, mutation):
    doc, digest = _jax_entry(tmp_path, {"kind": "linear", "L": 16,
                                        "C_in": 256, "C_out": 256},
                             {"bm": 8, "bn": 256, "bk": 256})
    bad = MUTATIONS[mutation](copy.deepcopy(doc))
    rules = lambda diags: [d.rule for d in diags]
    for expect in (None, digest):
        assert rules(verify_tune_entry(copy.deepcopy(bad),
                                       expect_key=expect)) == \
            rules(jax_verify_tune_entry(copy.deepcopy(bad),
                                        expect_key=expect))
    if mutation == "clean":
        assert verify_tune_entry(doc, expect_key=digest) == []
    else:
        assert verify_tune_entry(bad, expect_key=digest)


def test_verify_tune_entry_holds_port_entries_to_the_launch_table(tmp_path):
    op = OPS["conv"]
    key = TuneKey.for_op(op, *CARD)
    path = TuneCache(tmp_path).put(
        key, tiles.launch_spec("conv").config(bm=64, bn=128), [])
    doc = json.loads(path.read_text())
    assert verify_tune_entry(doc, expect_key=key.key) == []
    assert verify_path(path) == ("tune", [])
    cases = {"tile.legality": {**doc, "tile": {"bm": 64, "bn": 64}},
             "provenance.digest": {**doc, "key": {**doc["key"],
                                                  "backend": "gpu"}},
             "schema.version": {**doc, "schema_version": 3},
             "schema.malformed": {**doc, "kernels": "volta"}}
    for rule, bad in cases.items():
        got = [d.rule for d in verify_tune_entry(bad, expect_key=key.key)]
        assert rule in got, (rule, got)
    # the reference refuses a port entry: its tile is not a TPU tile
    assert [d.rule for d in jax_verify_tune_entry(doc)] == ["tile.legality"]


# ---------------------------------------------- tile-aware predictors

def test_tile_features_are_the_references():
    from repro.core.types import AttnOp as JaxAttnOp
    from repro.core.types import SSMOp as JaxSSMOp
    for kind in ("linear", "conv", "attention", "ssm"):
        assert tile_feature_names(kind) == jax_tile_feature_names(kind)
        for wb in (True, False):
            assert feature_names(kind, wb, tiles=True) == \
                jax_feature_names(kind, wb, tiles=True)
    ops = [LinearOp(16, 256, 256), LinearOp(64, 128, 512)]
    jops = [JaxLinearOp(16, 256, 256), JaxLinearOp(64, 128, 512)]
    ts = [registry.tile_spec("linear").config(bm=8, bn=256, bk=256), None]
    jts = [jax_registry.tile_spec("linear").config(bm=8, bn=256, bk=256),
           None]
    np.testing.assert_array_equal(tile_features(ops, ts),
                                  jax_tile_features(jops, jts))
    np.testing.assert_array_equal(tile_features(ops),
                                  jax_tile_features(jops))
    for op, jop in ((AttnOp(H=4, S=256, KV=2, hd=16),
                     JaxAttnOp(H=4, S=256, KV=2, hd=16)),
                    (SSMOp(T=64, H=2, hd=8, N=16),
                     JaxSSMOp(T=64, H=2, hd=8, N=16)),
                    (ConvOp(8, 8, 32, 128), JaxConvOp(8, 8, 32, 128))):
        np.testing.assert_array_equal(tile_features([op]),
                                      jax_tile_features([jop]))


@pytest.mark.parametrize("backend", ["gpu", "cpu3"])
def test_tile_aware_training_predicts_and_checksums_like_the_reference(
        backend):
    from repro_torch.core.predictor.gbdt import GBDTParams
    from repro.core.predictor.gbdt import GBDTParams as JaxGBDTParams
    ops, jops = sample_linear_ops(80, seed=1), jax_sample_linear_ops(80,
                                                                     seed=1)
    assert [registry.op_to_json(o) for o in ops] == \
        [jax_registry.op_to_json(o) for o in jops]

    def tile_list(spec_of, ops_):
        # every third op at the last legal tile of its grid, others default
        return [spec_of("linear").configs(op)[-1] if i % 3 == 0 else None
                for i, op in enumerate(ops_)]

    port = train_predictor(ops, "moto2022", backend, tiles=True,
                           tile_list=tile_list(registry.tile_spec, ops),
                           params=GBDTParams(n_estimators=10))
    ref = jax_train(jops, "moto2022", backend, tiles=True,
                    tile_list=tile_list(jax_registry.tile_spec, jops),
                    params=JaxGBDTParams(n_estimators=10))
    assert port.tile_aware and ref.tile_aware
    probe, jprobe = ops[:12], jops[:12]
    for ts, jts in ((None, None),
                    (tile_list(registry.tile_spec, probe),
                     tile_list(jax_registry.tile_spec, jprobe))):
        np.testing.assert_array_equal(port.predict(probe, ts),
                                      ref.predict(jprobe, jts))
    assert predictor_checksum(port) == jax_checksum(ref)
    blind = train_predictor(ops, "moto2022", backend,
                            params=GBDTParams(n_estimators=10))
    assert not blind.tile_aware
    assert predictor_checksum(blind) == jax_checksum(jax_train(
        jops, "moto2022", backend, params=JaxGBDTParams(n_estimators=10)))
    assert predictor_checksum(port) != predictor_checksum(blind)


def test_mux_and_calibrated_predictors_forward_tiles():
    from repro_torch.core.predictor.gbdt import GBDTParams
    from repro_torch.core.predictor.train import MuxPredictor
    from repro_torch.measure.calibrate import Calibrator
    ops = sample_linear_ops(40, seed=2)
    lin = train_predictor(ops, "moto2022", "gpu", tiles=True,
                          params=GBDTParams(n_estimators=6))
    mux = MuxPredictor(lin, lin)
    ts = [registry.tile_spec("linear").configs(op)[-1] for op in ops[:5]]
    np.testing.assert_array_equal(mux.predict(ops[:5], ts),
                                  lin.predict(ops[:5], ts))
    wrapped = Calibrator(corrections={}, n_records=0).wrap(mux)
    np.testing.assert_array_equal(wrapped.predict(ops[:5], ts),
                                  lin.predict(ops[:5], ts))


# ------------------------------------------------------ autotune itself

def _inject(monkeypatch, times, calls=None, rest=90.0):
    """Measure nothing: `measure_tile_us` reads `times[label]` (`rest` us
    for a label it lacks) and the measured card is `CARD`."""
    def fake(op, launch, **kw):
        label = (launch or tiles.Launch(registry.op_kind(op))).label()
        if calls is not None:
            calls.append((registry.op_label(op), label))
        return times.get(label, rest)
    monkeypatch.setattr(at, "measure_tile_us", fake)
    monkeypatch.setattr(at, "measure_device", lambda: CARD)


def test_measuring_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for call in (at.measure_device,
                 lambda: at.measure_tile_us(OPS["conv"]),
                 lambda: autotune(OPS["conv"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_autotune_hysteresis_and_cache(tmp_path, monkeypatch):
    op = OPS["conv"]
    spec = tiles.launch_spec("conv")
    winner = spec.config(bm=128, bn=64)
    times = {"default": 100.0, "bm128/bn64": 50.0}
    _inject(monkeypatch, times)
    cache = TuneCache(tmp_path)
    assert autotune(op, cache=cache) == winner and cache.misses == 1
    doc = json.loads(cache.path_for(TuneKey.for_op(op, *CARD)).read_text())
    assert [label for label, _ in doc["measured_us"]] == \
        [c.label() for c in spec.configs(registry.launch_extents(op))]
    # warm: from disk, nothing measured
    monkeypatch.setattr(at, "measure_tile_us",
                        lambda *a, **k: pytest.fail("measured on warm hit"))
    assert autotune(op, cache=TuneCache(tmp_path)) == winner
    # hysteresis: a 1 % win does not dethrone the default
    _inject(monkeypatch, {**times, "bm128/bn64": 99.5}, rest=100.0)
    assert autotune(op) == spec.default()
    # a direct conv has no kernel to time: its default, measured never
    direct = ConvOp(H_in=8, W_in=8, C_in=3, C_out=16)
    monkeypatch.setattr(at, "measure_tile_us",
                        lambda *a, **k: pytest.fail("timed a direct conv"))
    assert autotune(direct, device=CARD[0], backend=CARD[1]).is_default


def test_relaxed_search_reaches_the_reduction_axis(monkeypatch):
    _inject(monkeypatch, {"default": 100.0, "splits8": 80.0})
    op = OPS["linear"]
    assert autotune(op).is_default                  # not searched
    assert autotune(op, preserve_numerics=False) == \
        tiles.launch_spec("linear").config(splits=8)


def test_annotate_plan_tiles_dedups_ops_and_leaves_the_plan(monkeypatch,
                                                             tmp_path):
    calls = []
    _inject(monkeypatch, {"bm128/bn64": 10.0}, calls)
    port = repro_torch.compile(
        [to_port(op) for op in _vgg_like_ops()] * 2,
        repro_torch.Target(device="moto2022", threads=3),
        cache=tmp_path / "plans", **SMALL)
    before = json.dumps(port.plan.to_json(), sort_keys=True)
    entries = annotate_plan_tiles(port.plan)
    assert json.dumps(port.plan.to_json(), sort_keys=True) == before
    ops = list(dict.fromkeys(d.op for d in port.decisions))
    assert [at.entry_op(e) for e in entries] == ops
    # each op with a kernel of the port timed once, its candidates in turn
    timed = [op_label for op_label, _ in calls]
    kernel_ops = [op for op in ops if registry.launch_extents(op)]
    assert sorted(set(timed)) == sorted(registry.op_label(op)
                                        for op in kernel_ops)
    assert len(timed) == sum(
        len(tiles.launch_spec(registry.op_kind(op)).configs(
            registry.launch_extents(op))) for op in kernel_ops)


def _vgg_like_ops():
    return [JaxConvOp(32, 32, 64, 128, 3, 1), JaxConvOp(16, 16, 128, 128),
            JaxLinearOp(1, 512, 256)]


# --------------------------------------------------- compile(tune=True)

@pytest.fixture()
def tuned_pair(tmp_path, monkeypatch):
    """The small network compiled untuned and tuned (the injected
    measurement makes bm128/bn64 the winner of every Winograd conv)."""
    _inject(monkeypatch, {"bm128/bn64": 10.0})
    target = repro_torch.Target(device="moto2022", threads=3)
    net = [(k, to_port(p) if k != "pool" else p) for k, p in small_units()]
    kw = dict(cache=tmp_path / "plans", predictor_cache=tmp_path / "pred",
              **SMALL)
    base = repro_torch.compile(net, target, **kw)
    tuned = repro_torch.compile(net, target, tune=True,
                                tune_cache=tmp_path / "tune", **kw)
    return base, tuned, net, target, kw, tmp_path


def _doc_without_tune(plan):
    doc = json.loads(plan.dumps())
    tag = doc["provenance"].pop("tune", "")
    return doc, tag


def test_compile_tune_true_keys_documents_and_warm_hits(tuned_pair,
                                                        monkeypatch):
    base, tuned, net, target, kw, tmp = tuned_pair
    assert base.key != tuned.key
    assert base.provenance.tune == "" and base.tuned is None
    assert tuned.provenance.tune == tune_cache_version()
    # the document: the untuned one with the tag, no Hopper value in it
    a, tag_a = _doc_without_tune(base.plan)
    b, tag_b = _doc_without_tune(tuned.plan)
    assert (tag_a, tag_b) == ("", tune_cache_version()) and a == b
    assert '"tile"' not in tuned.plan.dumps()
    winograd = [d.op for d in tuned.decisions
                if registry.launch_extents(d.op)
                and registry.op_kind(d.op) == "conv"]
    assert winograd and all(
        tuned.launches[op] == tiles.launch_spec("conv").config(bm=128, bn=64)
        for op in winograd)
    assert all(launch.is_default for op, launch in tuned.launches.items()
               if op not in winograd)
    assert f"tune={tune_cache_version()}" in tuned.explain()
    # warm: a plan-cache hit, and the tune cache's entries, measuring nothing
    monkeypatch.setattr(at, "measure_tile_us",
                        lambda *a, **k: pytest.fail("tuned on warm hit"))
    warm = repro_torch.compile(net, target, tune=True,
                               tune_cache=tmp / "tune", **kw)
    assert warm.from_cache and warm.key == tuned.key
    assert warm.tuned == tuned.tuned and warm.launches == tuned.launches


def test_an_all_default_tune_changes_only_the_tag(tmp_path, monkeypatch):
    _inject(monkeypatch, {"default": 10.0})
    target = repro_torch.Target(device="moto2022", threads=3)
    net = [(k, to_port(p) if k != "pool" else p) for k, p in small_units()]
    kw = dict(cache=tmp_path / "plans", **SMALL)
    base = repro_torch.compile(net, target, **kw)
    tuned = repro_torch.compile(net, target, tune=True,
                                tune_cache=tmp_path / "tune", **kw)
    a, _ = _doc_without_tune(base.plan)
    b, tag = _doc_without_tune(tuned.plan)
    assert tag == tune_cache_version() and a == b
    assert all(launch.is_default for launch in tuned.launches.values())


def test_port_tuned_plans_pass_the_reference_verifier_and_never_alias(
        tuned_pair, monkeypatch):
    base, tuned, net, target, kw, tmp = tuned_pair
    assert not jax_errors(jax_verify_plan(tuned.plan.to_json(),
                                          expect_key=tuned.key))
    # the reference tuning the same network lands on another key
    monkeypatch.setattr(jax_at, "measure_tile_us", lambda *a, **k: 10.0)
    ref = repro.compile(small_units(), repro.Target(device="moto2022",
                                                    threads=3),
                        cache=tmp / "jax_plans", tune=True,
                        tune_cache=tmp / "jax_tune", **SMALL)
    assert ref.provenance.tune == "tune-v1.k1"
    assert ref.key not in (tuned.key, base.key)
    assert ref.plan.provenance.network_fingerprint == \
        tuned.provenance.network_fingerprint


def test_a_tuned_artifact_saves_and_loads_with_its_sidecar(tuned_pair):
    base, tuned, *_, tmp = tuned_pair
    path = tuned.save(tmp / "art" / "small.coexec.json")
    side = sidecar_path(path)
    assert side.name == "small.coexec.hopper_tiles.json"
    assert json.loads(side.read_text()) == tuned.tuned
    assert verify_path(side)[0] == "tune" and not verify_path(side)[1]
    assert verify_path(path) == ("artifact", verify_path(path)[1])
    assert not [d for d in verify_path(path)[1] if d.severity == "error"]
    back = repro_torch.CompiledNetwork.load(path)
    assert back.key == tuned.key and back.launches == tuned.launches
    # the reference loads the port-tuned artifact strictly too
    assert repro.CompiledNetwork.load(path).key == tuned.key
    y_tuned = back.run(device="cpu")
    assert torch.equal(y_tuned, base.run(device="cpu"))
    assert torch.equal(back.run(device="cpu", fused=True), y_tuned)
    # without its sidecar the artifact refuses to load, and to verify
    side.unlink()
    with pytest.raises(VerificationError, match="sidecar"):
        repro_torch.CompiledNetwork.load(path)
    assert any(d.rule == "artifact.format" for d in verify_path(path)[1])
    # a sidecar that leaves an op out, or holds a reference entry, refuses
    partial = [e for e in tuned.tuned if "conv" not in e["key"]["op_json"]
               ["kind"]]
    side.write_text(json.dumps(partial))
    with pytest.raises(VerificationError, match="no tune entry"):
        repro_torch.CompiledNetwork.load(path)
    side.write_text(json.dumps([{k: v for k, v in e.items()
                                 if k != "kernels"} for e in tuned.tuned]))
    with pytest.raises(VerificationError, match="not a Hopper tune entry"):
        repro_torch.CompiledNetwork.load(path)
    # an untuned artifact takes no sidecar
    with pytest.raises(VerificationError, match="did not tune"):
        repro_torch.CompiledNetwork.from_json(base.to_json(),
                                              tuned=tuned.tuned)


def _launch_hook(fn):
    """Run `fn` and return the (kernel, launch label) of every kernel
    wrapper call it makes, seen by a profile hook as the call is made."""
    from repro_torch.runtime.segments import launch_counters
    codes = {w.__code__: name for name, w in launch_counters().items()}
    seen = []

    def hook(frame, event, _arg):
        if event == "call" and frame.f_code in codes:
            launch = frame.f_locals.get("launch")
            seen.append((codes[frame.f_code],
                         "default" if launch is None else launch.label()))
    sys.setprofile(hook)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return seen


def test_tuned_launches_reach_the_kernels_in_both_walks(tuned_pair):
    """Every hadamard_matmul call of the tuned network carries its op's
    tuned tile, fitted to its side; the fused walk makes the same calls."""
    base, tuned, *_ = tuned_pair
    exe = tuned.executor(device="cpu")
    x = exe.input_template()
    per_node = _launch_hook(lambda: exe.run(x))
    fused = _launch_hook(lambda: exe.run(x, fused=True))
    assert sorted(per_node) == sorted(fused)
    want = []
    for spec in exe.specs:
        if spec.op is None or not registry.launch_extents(spec.op):
            continue
        kernel = {"linear": "split_matmul", "conv": "hadamard_matmul"}[
            spec.unit]
        launch = tuned.launches[spec.op]
        widths = [spec.c_fast, spec.c_slow] if spec.coexec else [None]
        for n in widths:
            if n == 0:
                continue
            fit = (launch if n is None else registry.fit_launch(
                launch, spec.op, n=n))
            want.append((kernel, fit.label()))
    assert sorted(per_node) == sorted(want)
    assert any(label != "default" for _, label in per_node)
    assert all(label == "default"
               for _, label in _launch_hook(
                   lambda: base.executor(device="cpu").run(x)))


def _decode_plan(attn_axis, attn_fast, t):
    """A decoder graph with a typed attention split and an ssm-state
    split, built from the port's own codecs."""
    from repro_torch.graph.ir import Graph
    from repro_torch.runtime.plan import CoexecPlan, PlanProvenance
    nodes = [("q", LinearOp(t, 64, 128), (), 64),
             ("a", AttnOp(H=8, S=512, KV=4, hd=16), ("q",), attn_fast),
             ("i", LinearOp(t, 128, 128), ("a",), 64),
             ("s", SSMOp(T=t, H=8, hd=16, N=16), ("i",), 3)]
    axis = {"a": attn_axis, "s": "ssm-state"}
    size = {"channel": lambda op: op.C_out, "head": lambda op: op.H,
            "kv-block": lambda op: op.S, "ssm-state": lambda op: op.H}
    graph, schedule = [], []
    for nid, op, inputs, fast in nodes:
        kind = registry.op_kind(op)
        ax = axis.get(nid, "channel")
        graph.append({"id": nid, "kind": kind,
                      "op": registry.op_to_json(op), "inputs": list(inputs)})
        dec = {"op": registry.op_to_json(op), "c_cpu": size[ax](op) - fast,
               "c_gpu": fast, "pred_cpu_us": 1.0, "pred_gpu_us": 1.0,
               "pred_total_us": 1.0}
        if ax != "channel":
            dec["axis"] = ax
        schedule.append({"id": nid, "unit": kind, "decision": dec})
    graph_json = {"schema_version": 2, "nodes": graph}
    prov = PlanProvenance(
        device="moto2022", threads=3, mechanism="svm_poll", step=8, seed=1,
        network_fingerprint=Graph.from_json(graph_json).fingerprint(),
        predictor_checksum="test")
    return CoexecPlan(provenance=prov, schedule=schedule,
                      graph_json=graph_json)


@pytest.mark.parametrize("attn_axis,attn_fast", [("head", 4),
                                                 ("kv-block", 128)])
def test_typed_split_sides_fit_the_tuned_launch(attn_axis, attn_fast):
    """The reference's HEAD_TILE_OK / SSM_TILE_OK on the port: each side
    of a head, kv-block or ssm-state split takes the op's tuned launch
    fitted to its own sub-op, and the outputs stay within tolerance of
    the untuned run (the plain SSD scan follows the chunk)."""
    from repro_torch.runtime.executor import PlanExecutor
    plan = _decode_plan(attn_axis, attn_fast, t=32)
    attn, ssm = plan.decisions[1].op, plan.decisions[3].op
    launches = {attn: tiles.launch_spec("attention").config(run_tiles=16),
                ssm: tiles.launch_spec("ssm").config(chunk=16)}
    tuned = PlanExecutor(plan, device="cpu", launches=launches)
    base = PlanExecutor(plan, device="cpu")
    x = base.input_template()
    seen = _launch_hook(lambda: tuned.run(x))
    sub = registry.axis_spec("attention", attn_axis).sub
    fast, slow = sub(attn, attn_fast), sub(attn, attn_axis == "head"
                                           and attn.H - attn_fast
                                           or attn.S - attn_fast)
    want_attn = sorted(registry.fit_launch(launches[attn], s).label()
                       for s in (fast, slow))
    assert sorted(l for k, l in seen if k == "decode_attention") == \
        want_attn
    assert [l for k, l in seen if k == "ssd_chunk_scan"] == ["chunk16"] * 2
    y, _ = tuned.run(x)
    np.testing.assert_allclose(y.numpy(), base.run(x)[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    if attn_axis == "kv-block":        # 4 and 12 tiles: run_tiles clamped
        assert want_attn == ["run_tiles12", "run_tiles4"]


# ------------------------------------- a reference-tuned VGG16 artifact

def _vgg16_units(size):
    """VGG16's 13 convs, 5 pools and 3 linears, with its widths, at a
    `size` x `size` input (the CPU cannot run 224 x 224 in a test)."""
    units, h, c_in = [], size, 3
    for c_out, reps in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(reps):
            units.append(("conv", JaxConvOp(h, h, c_in, c_out, 3, 1)))
            c_in = c_out
        units.append(("pool", 4 * (h // 2) * (h // 2) * c_out))
        h //= 2
    return units + [("linear", JaxLinearOp(1, h * h * 512, 4096)),
                    ("linear", JaxLinearOp(1, 4096, 4096)),
                    ("linear", JaxLinearOp(1, 4096, 1000))]


def _reference_tuned(tmp_path, monkeypatch, network):
    """`network` compiled by the reference with tune=True, its measurement
    made to pick bm=64 (a non-default TPU tile) wherever the grid has it."""
    def fake(op, tile, **kw):
        cfg = jax_registry.resolve_tile(op, tile)
        return 10.0 if cfg.as_dict().get("bm") == 64 else 90.0
    monkeypatch.setattr(jax_at, "measure_tile_us", fake)
    return repro.compile(network, repro.Target(device="moto2022", threads=3),
                         cache=tmp_path / "jax_plans", tune=True,
                         tune_cache=tmp_path / "jax_tune", **SMALL)


def test_reference_tuned_vgg16_loads_strictly_in_the_port(tmp_path,
                                                          monkeypatch):
    ref = _reference_tuned(tmp_path, monkeypatch, "vgg16")
    path = ref.save(tmp_path / "vgg16.tuned.json")
    assert any(d.tile is not None for d in ref.decisions)
    port = repro_torch.CompiledNetwork.load(path)
    assert port.key == ref.key and port.provenance.tune == "tune-v1.k1"
    assert port.to_json() == json.loads(path.read_text())
    assert [None if d.tile is None else d.tile.label()
            for d in port.decisions] == \
        [None if d.tile is None else d.tile.label() for d in ref.decisions]
    assert port.tuned is None and port.launches == {}   # default launches


def test_reference_tuned_vgg16_runs_on_the_cpu_like_the_reference(
        tmp_path, monkeypatch):
    """The reduced VGG16 (64 x 64 input, VGG16's widths), tuned by the
    reference: strict load in the port, then both walks on two CPU groups
    against the reference's run on the same seeded weights and input,
    within chip_smoke.py's VGG16 tolerance (Winograd reassociates the
    fp32 sums of the 32 x 32 layers' convs)."""
    ref = _reference_tuned(tmp_path, monkeypatch, _vgg16_units(64))
    assert any(d.tile is not None for d in ref.decisions)
    path = ref.save(tmp_path / "vgg16_64.tuned.json")
    jexe = JaxPlanExecutor(ref.plan, seed=0)
    x = np.asarray(jexe.input_template())
    want = np.asarray(jexe.run_oracle())
    port = repro_torch.CompiledNetwork.load(path)
    exe = port.executor(device="cpu")
    y, _ = exe.run(x)
    y_fused, _ = exe.run(x, fused=True)
    assert y.shape == want.shape == (1, 1000)
    scale = float(np.abs(want).max())
    assert float(np.abs(y.numpy() - want).max()) <= 2e-3 * scale
    assert torch.equal(y_fused, y)


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("args", [
    ["tune", "--network", "resnet18"],
    ["plan", "--network", "resnet18", "--tune"],
    ["tune", "--model", "tiny_hybrid", "--reps", "1"]])
def test_cli_tune_refuses_without_cuda(args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = blocked_cli([*args, "--cache-dir", str(tmp_path / "plans"),
                        "--tune-cache-dir", str(tmp_path / "tune")],
                       tmp_path)
    assert proc.returncode == 2, proc.stderr
    assert "CUDA" in proc.stderr and "Traceback" not in proc.stderr
    assert not (tmp_path / "plans").exists()
    assert not (tmp_path / "tune").exists()


def test_cli_verify_covers_the_tune_cache(tuned_pair, monkeypatch):
    from repro_torch.cli import main
    *_, tmp = tuned_pair
    monkeypatch.chdir(tmp)
    (tmp / "reports").mkdir()
    (tmp / "tune").rename(tmp / "reports" / "tune")
    assert main(["verify", "--all-artifacts"]) == 0
    entry = sorted((tmp / "reports" / "tune").glob("*.json"))[0]
    doc = json.loads(entry.read_text())
    entry.write_text(json.dumps({**doc, "schema_version": 9}))
    assert main(["verify", "--all-artifacts"]) == 1
