"""Plan portfolios in the port against the reference's, on the CPU.

`compile_portfolio` in both packages (a live parity test at small
predictor sizes, and the committed zamba2-7b portfolio reproduced byte for
byte at the defaults), the portfolio codecs, `select` and `replace`, the
reference's portfolio mutations through both verifiers, a batch-4 bucket
of `tiny_hybrid` run by the port against the reference's `run_oracle`,
and the reshard and elision counts of forced typed-axis splits against
the reference executor's on eight virtual devices."""
import copy
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro
from repro.analysis import errors as jax_errors
from repro.analysis import verify_portfolio as jax_verify_portfolio
from repro.api import _artifact_checksum as jax_artifact_checksum
from repro.api import _portfolio_checksum as jax_portfolio_checksum
from repro.runtime.executor import PlanExecutor as JaxPlanExecutor
from repro.runtime.plan import train_mux_predictors as jax_train_mux

import repro_torch
from repro_torch.analysis import VerificationError, errors, verify_portfolio
from repro_torch.api import _artifact_checksum, _portfolio_checksum
from repro_torch.runtime.plan import train_mux_predictors

from test_torch_support import ROOT, forced_split_doc

PORTFOLIO = (ROOT / "src/repro_torch/artifacts/"
             "zamba2-7b_b9_moto2022_t1.portfolio.json")
SMALL = dict(samples=120, estimators=25)

#: (model, compile_portfolio kwargs) of the live parity cases
LIVE = {
    "tiny_hybrid default buckets": ("tiny_hybrid", dict(blocks=2)),
    "tiny_hybrid odd buckets": ("tiny_hybrid",
                                dict(blocks=3, buckets=((2, 96), (1, 512),
                                                        (8, 32)))),
    "tiny_decoder": ("tiny_decoder", dict(buckets=((1, 128), (4, 128)))),
}

def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def predictor_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("port_portfolio_predictors")


@pytest.fixture(scope="module")
def live(tmp_path_factory, predictor_cache):
    """Each live case compiled by both packages into fresh caches."""
    out = {}
    for name, (model, kw) in LIVE.items():
        root = tmp_path_factory.mktemp("portfolio")
        target = dict(device="moto2022", threads=3)
        port = repro_torch.compile_portfolio(
            model, repro_torch.Target(**target), cache=root / "plans",
            predictor_cache=predictor_cache, **SMALL, **kw)
        ref = repro.compile_portfolio(model, repro.Target(**target),
                                      cache=root / "jax_plans", **SMALL, **kw)
        out[name] = (port, ref, root)
    return out


# ----------------------------------------------------------- live parity
@pytest.mark.parametrize("name", sorted(LIVE))
def test_compile_portfolio_is_the_reference_portfolio(live, name,
                                                      predictor_cache):
    port, ref, root = live[name]
    assert port.to_json() == ref.to_json()
    assert port.buckets == [repro_torch.Bucket(b.batch, b.seq)
                            for b in ref.buckets]
    assert repr(port) == repr(ref)
    assert len(port) == len(ref)
    assert port.can_replan() and ref.can_replan()
    # every entry's provenance carries its bucket tag
    for b, c in port.entries.items():
        assert c.provenance.bucket == b.tag
    # compiling again is all warm hits, in either package's cache
    model, kw = LIVE[name]
    again = repro_torch.compile_portfolio(
        model, repro_torch.Target(device="moto2022", threads=3),
        cache=root / "jax_plans", predictor_cache=predictor_cache, **SMALL,
        **kw)
    assert all(c.from_cache for c in again.entries.values())
    assert again.to_json() == port.to_json()


@pytest.mark.parametrize("name", sorted(LIVE))
def test_portfolio_saves_and_loads_byte_for_byte(live, name, tmp_path):
    port, ref, _ = live[name]
    path = port.save(tmp_path / "port.json")
    ref.save(tmp_path / "ref.json")
    assert path.read_bytes() == (tmp_path / "ref.json").read_bytes()
    back = repro_torch.PlanPortfolio.load(path)
    jback = repro.PlanPortfolio.load(path)
    assert back.to_json() == jback.to_json() == port.to_json()
    assert not back.can_replan()                # artifacts carry none
    assert back.model == jback.model and back.mode == jback.mode


@pytest.mark.parametrize("name", sorted(LIVE))
def test_select_and_replace_pick_the_reference_buckets(live, name):
    port, ref, _ = live[name]
    for batch in (1, 2, 3, 4, 5, 8, 9):
        for seq in (1, 32, 64, 65, 128, 256, 300, 512, 4096):
            b, c = port.select(batch, seq)
            jb, jc = ref.select(batch, seq)
            assert (b.batch, b.seq, b.tag) == (jb.batch, jb.seq, jb.tag)
            assert c.key == jc.key
            assert b.covers(batch, seq) == jb.covers(batch, seq)
    first = port.buckets[0]
    swapped = repro_torch.PlanPortfolio(port.model, port.target,
                                        dict(port.entries))
    other = port.entries[port.buckets[-1]]
    swapped.replace(first, other)
    assert swapped.entries[first] is other
    with pytest.raises(KeyError) as e:
        swapped.replace(repro_torch.Bucket(99, 1), other)
    with pytest.raises(KeyError) as je:
        ref.replace(repro.Bucket(99, 1), ref.entries[ref.buckets[0]])
    assert str(e.value) == str(je.value)


def _message(fn, exc=ValueError):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("model,buckets", [
    ("tiny_hybrid", ((1, 64), (1, 64))),
    ("tiny_hybrid", ((0, 64),)),
    ("tiny_hybrid", ((1, -4),)),
    ("vgg16", ((1, 64),)),
])
def test_compile_portfolio_refuses_as_the_reference(model, buckets,
                                                    tmp_path):
    pair = train_mux_predictors("moto2022", 3, **SMALL)
    jpair = jax_train_mux("moto2022", 3, **SMALL)
    got = _message(lambda: repro_torch.compile_portfolio(
        model, repro_torch.Target(device="moto2022"), buckets=buckets,
        cache=tmp_path, predictors=pair))
    want = _message(lambda: repro.compile_portfolio(
        model, repro.Target(device="moto2022"), buckets=buckets,
        cache=tmp_path, predictors=jpair))
    assert got == want
    assert _message(lambda: repro_torch.PlanPortfolio(
        "m", repro_torch.Target(device="moto2022"), {})) == \
        _message(lambda: repro.PlanPortfolio(
            "m", repro.Target(device="moto2022"), {}))


# ------------------------------------------------ the committed portfolio
def test_committed_portfolio_is_reproduced_byte_for_byte(tmp_path):
    """`compile_portfolio("zamba2-7b", Target(device="moto2022",
    threads=1), blocks=9)` at the default predictors and buckets writes
    the committed file, in the port, with no JAX involved."""
    target = repro_torch.Target(device="moto2022", threads=1)
    pf = repro_torch.compile_portfolio("zamba2-7b", target, blocks=9,
                                       cache=tmp_path / "plans")
    assert [b.tag for b in pf.buckets] == ["b1s64", "b4s64", "b4s256"]
    assert all(not c.from_cache for c in pf.entries.values())
    path = pf.save(tmp_path / "portfolio.json")
    assert path.read_bytes() == PORTFOLIO.read_bytes()
    again = repro_torch.compile_portfolio("zamba2-7b", target, blocks=9,
                                          cache=tmp_path / "plans")
    assert all(c.from_cache for c in again.entries.values())


def test_committed_portfolio_strict_loads_in_both_packages():
    port = repro_torch.PlanPortfolio.load(PORTFOLIO)
    ref = repro.PlanPortfolio.load(PORTFOLIO)
    doc = json.loads(PORTFOLIO.read_text())
    assert port.to_json() == ref.to_json() == doc
    assert doc["checksum"] == _portfolio_checksum(doc) == \
        jax_portfolio_checksum(doc)
    for b, c in port.entries.items():
        jc = ref.entries[repro.Bucket(b.batch, b.seq)]
        assert c.key == jc.key and c.provenance.bucket == b.tag
        assert c.explain() == jc.explain()
        # the decode graph at published widths, batch folded into rows
        rows = {n.op.L for n in c.graph if n.kind == "linear"}
        assert rows == {b.batch}
        attn = c.decisions_by_node["b8.attn"]
        assert (attn.op.S, attn.op.H, attn.op.hd) == (b.seq, 32, 112)


# -------------------------------------------------------------- mutations
def _rechecksum(doc, entry=None):
    if entry is not None:
        art = doc["entries"][entry]["artifact"]
        art["checksum"] = jax_artifact_checksum(art)
        assert art["checksum"] == _artifact_checksum(art)
    doc["checksum"] = jax_portfolio_checksum(doc)
    return doc


def _set(doc, path, value):
    *head, last = path
    for k in head:
        doc = doc[k]
    doc[last] = value


def _share(doc):
    dec = next(e["decision"] for e in
               doc["entries"][1]["artifact"]["plan"]["schedule"]
               if e.get("id") == "b0.in_proj")
    dec["c_gpu"] += 8                   # shares no longer sum to C_out
    return _rechecksum(doc, 1)


#: the reference's portfolio mutations (`tests/test_analysis.py`: an entry
#: whose tag no longer matches its plan, a tampered field) and more
MUTATIONS = {
    "entry batch": lambda d: (_set(d, ("entries", 0, "batch"), 2), d)[1],
    "entry batch, re-checksummed": lambda d: _rechecksum(
        (_set(d, ("entries", 0, "batch"), 2), d)[1]),
    "tampered mode": lambda d: (_set(d, ("mode",), "tampered"), d)[1],
    "format": lambda d: (_set(d, ("format",), "repro.other"), d)[1],
    "version": lambda d: _rechecksum((_set(d, ("version",), 2), d)[1]),
    "no checksum": lambda d: (d.pop("checksum"), d)[1],
    "plan bucket": lambda d: _rechecksum((_set(
        d, ("entries", 2, "artifact", "plan", "provenance", "bucket"),
        "b4s64"), d)[1], 2),
    "plan bucket dropped": lambda d: _rechecksum((d["entries"][0][
        "artifact"]["plan"]["provenance"].pop("bucket"), d)[1], 0),
    "entry artifact format": lambda d: _rechecksum((_set(
        d, ("entries", 1, "artifact", "format"), "x"), d)[1]),
    "entry artifact tampered": lambda d: _rechecksum((_set(
        d, ("entries", 1, "artifact", "mode"), "grid"), d)[1]),
    "share": _share,
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_portfolio_mutations_give_the_reference_rules(name):
    doc = MUTATIONS[name](json.loads(PORTFOLIO.read_text()))
    diags = verify_portfolio(copy.deepcopy(doc))
    jdiags = jax_verify_portfolio(copy.deepcopy(doc))
    rules = {d.rule for d in errors(diags)}
    assert rules and rules == {d.rule for d in jax_errors(jdiags)}
    assert [str(d) for d in errors(diags)] == \
        [str(d) for d in jax_errors(jdiags)]
    with pytest.raises(VerificationError):
        repro_torch.PlanPortfolio.from_json(copy.deepcopy(doc))


def test_portfolio_bucket_rule_names_the_entry():
    doc = MUTATIONS["entry batch, re-checksummed"](
        json.loads(PORTFOLIO.read_text()))
    bad = [d for d in errors(verify_portfolio(doc))
           if d.rule == "portfolio.bucket"]
    assert len(bad) == 1 and bad[0].node == "b2s64"
    assert "'b2s64' != plan provenance bucket 'b1s64'" in bad[0].message
    # a load that skips plan verification still checks the checksums, not
    # the bucket tags
    loaded = repro_torch.PlanPortfolio.from_json(doc, verify=False)
    assert [b.tag for b in loaded.buckets][0] == "b2s64"


# ----------------------------------------------------- batch-4 on the CPU
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_portfolio",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_runs_the_committed_portfolio():
    """The portfolio phase of `chip_smoke.py` compiles and runs the
    committed file, and derives each entry's counts from its plan."""
    mod = _chip_smoke()
    assert mod.PORTFOLIO == PORTFOLIO
    loaded = repro_torch.PlanPortfolio.load(PORTFOLIO)
    # the live step whose entry the phase replans: select routes it to the
    # smallest bucket that covers it
    assert loaded.select(*mod.PORTFOLIO_STEP)[0].tag == "b4s256"
    counts = {b.tag: mod.expected_counts(c.plan) for b, c in
              loaded.entries.items()}
    assert {tag: (c["decode_attention"], c["ssd_chunk_scan"])
            for tag, c in counts.items()} == \
        {"b1s64": (2, 8), "b4s64": (2, 8), "b4s256": (2, 8)}
    assert all(c["split_matmul"] > 0 for c in counts.values())


#: splits forced onto a batch-4 entry of the live tiny_hybrid portfolio
#: (b0: in_proj -> ssm -> out_proj; b1: q_proj -> attn -> o_proj -> mlp),
#: so that the typed lowerings take the batch-4 rows: (seq, splits)
FORCED_B4 = {
    "as compiled s64": (64, {}),
    "as compiled s256": (256, {}),
    "head": (64, {"b1.q_proj": 40, "b1.attn": ("head", 2),
                  "b1.o_proj": 24}),
    "kv-block": (256, {"b1.attn": ("kv-block", 128), "b1.mlp_up": 64}),
    "ssm-state": (64, {"b0.in_proj": 64, "b0.ssm": ("ssm-state", 1),
                       "b0.out_proj": 16}),
}

#: every forced plan whose walks' reshard and elision counts are held
#: against the reference executor's: the batch-4 ones above, and typed
#: splits on the batch-1 entry, where (as in the replanned zamba2-7b
#: plan) the channel splits around them chain into and out of them on the
#: per-node walk: (batch, seq, splits)
FORCED = {**{f"b4 {name}": (4, seq, splits)
             for name, (seq, splits) in FORCED_B4.items()},
          "b1 head": (1, 64, {"b1.q_proj": 32, "b1.attn": ("head", 2),
                              "b1.o_proj": 32}),
          "b1 ssm-state": (1, 64, {"b0.in_proj": 64,
                                   "b0.ssm": ("ssm-state", 2),
                                   "b0.out_proj": 32})}


def _forced_doc(ref_pf, batch, seq, splits):
    """The reference portfolio's (batch, seq) entry with `splits` forced.
    Forced splits leave the embedded segment metadata stale: it is
    dropped, so both packages re-derive the partition from the
    decisions."""
    doc = forced_split_doc(ref_pf.entries[repro.Bucket(batch, seq)], splits)
    if splits:
        doc["plan"].pop("segments")
        doc["checksum"] = jax_artifact_checksum(doc)
    return doc


#: the reference executor on a two-group mesh of eight virtual CPU
#: devices (a fresh process: the device count is fixed at jax's start),
#: for each document path: its per-node and fused walks' (reshard points,
#: elided) where the walk runs, else the error, and the same two counts
#: summed over its segment programs, which is what its fused walk adds
#: up (`PlanExecutor._execute_fused`) and what it gives without running
#: a shard_map program
_REFERENCE_COUNTS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import repro
    from repro.core.coexec import coexec_mesh
    from repro.runtime.executor import PlanExecutor
    mesh = coexec_mesh(jax.devices())
    out = {}
    for path in sys.argv[1:]:
        plan = repro.CompiledNetwork.load(path).plan
        exe = PlanExecutor(plan, mesh=mesh, seed=0)
        programs = exe.segment_programs()
        res = {"split_capable": exe.split_capable,
               "programs": [sum(p.gathers for p in programs),
                            sum(p.elided for p in programs)]}
        for walk, kw in (("per_node", {}), ("fused", {"fused": True})):
            try:
                _, rep = exe.run(**kw)
                res[walk] = [rep.reshard_points, rep.elided]
            except Exception as e:
                res[walk] = type(e).__name__ + ": " + str(e).splitlines()[0]
        out[path] = res
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def forced(live, tmp_path_factory):
    """Each `FORCED` plan's document, and the reference executor's counts
    of it on eight virtual devices, by variant."""
    _, ref_pf, _ = live["tiny_hybrid default buckets"]
    root = tmp_path_factory.mktemp("forced")
    docs, paths = {}, {}
    for name, (batch, seq, splits) in FORCED.items():
        docs[name] = _forced_doc(ref_pf, batch, seq, splits)
        paths[name] = root / f"{name.replace(' ', '_')}.json"
        paths[name].write_text(json.dumps(docs[name]))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_COUNTS,
         *(str(p) for p in paths.values())],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    return {name: (docs[name], counts[str(paths[name])]) for name in FORCED}


@pytest.mark.parametrize("variant", sorted(FORCED))
def test_forced_splits_reshard_and_elide_as_the_reference(forced, variant):
    """The port's per-node and fused walks count the reshard points and
    elided gathers the reference executor counts on the same document,
    typed-axis splits included (each a singleton of the fused walk)."""
    doc, ref = forced[variant]
    assert ref["split_capable"]
    exe = repro_torch.CompiledNetwork.from_json(doc).executor(device="cpu")
    x = exe.input_template()
    _, report = exe.run(x)
    _, fused_report = exe.run(x, fused=True)
    port = {"per_node": [report.reshard_points, report.elided],
            "fused": [fused_report.reshard_points, fused_report.elided]}
    assert port["fused"] == ref["programs"]
    # where the reference's walk runs: under jax 0.9.0 its kv-block and
    # typed-split merge shard_map programs fail `check_vma`, and its
    # ssm-state split of a one-token scan fails in `lax.scan` (ROADMAP,
    # reference caveats); its fused counts are then its programs' sums
    for walk in ("per_node", "fused"):
        if isinstance(ref[walk], list):
            assert port[walk] == ref[walk]
    # the counts `chip_smoke.py` holds card runs to
    smoke = _chip_smoke()
    want = smoke.expected_counts(exe.plan)
    assert port["per_node"] == [want["reshard"], want["elided"]]
    assert tuple(port["fused"]) == smoke.fused_reshard_counts(exe.plan)
    if variant.startswith("b1 "):         # chains into and out of the split
        assert report.elided == 2 and fused_report.elided == 0


@pytest.mark.parametrize("variant", sorted(FORCED))
def test_chip_smoke_captures_every_kernel_call_of_a_walk(forced, variant):
    """`chip_smoke.kernel_calls` sees every kernel call of one request
    (they add up to the plan's counts) with its arguments, which
    `hold_walk_calls` holds against the plain versions on the card."""
    doc, _ = forced[variant]
    batch = FORCED[variant][0]
    smoke = _chip_smoke()
    exe = repro_torch.CompiledNetwork.from_json(doc).executor(device="cpu")
    calls = smoke.kernel_calls(exe, exe.input_template())
    want = smoke.expected_counts(exe.plan)
    for name, sigs in calls.items():
        assert sum(n for n, _ in sigs.values()) == want[name], name
        for n, args in sigs.values():
            wrapper = smoke.kernel_counters()[name]
            assert len(args) == len(inspect.signature(wrapper).parameters)
            assert all(not torch.is_tensor(a) or a.device.type == "cpu"
                       for a in args)
    # every linear is a GEMV over the batch's rows
    assert {args[0].shape[0] for _, args in
            calls["split_matmul"].values()} == {batch}
    split = FORCED[variant][2]
    if any(isinstance(v, tuple) and v[0] == "ssm-state"
           for v in split.values()):
        heads = sorted(args[0].shape[2] for n, args in
                       calls["ssd_chunk_scan"].values() for _ in range(n))
        assert heads == sorted([split["b0.ssm"][1], 4 - split["b0.ssm"][1]])


@pytest.mark.parametrize("variant", sorted(FORCED_B4))
def test_batch4_bucket_runs_as_the_reference_oracle(live, forced, variant):
    seq, splits = FORCED_B4[variant]
    port_pf, ref_pf, _ = live["tiny_hybrid default buckets"]
    port = port_pf.entries[repro_torch.Bucket(4, seq)]
    ref = ref_pf.entries[repro.Bucket(4, seq)]
    doc, ref_counts = forced[f"b4 {variant}"]
    assert doc == _forced_doc(ref_pf, 4, seq, splits)
    port_net = repro_torch.CompiledNetwork.from_json(doc)
    ref_net = repro.CompiledNetwork.from_json(doc)
    exe = port_net.executor(device="cpu")
    jexe = JaxPlanExecutor(ref_net.plan, seed=0)
    x = _np(jexe.input_template())
    assert x.shape == (4, 64)
    want = _np(jexe.run_oracle(x))
    y, report = exe.run(x)
    assert tuple(y.shape) == want.shape == (4, 64)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(_np(y) - want).max()) <= 1e-5 * scale
    y_fused, fused_report = exe.run(x, fused=True)
    assert torch.equal(y_fused, y)
    by_id = {t.node_id: t for t in report.timings}
    assert all(by_id[nid].mode == "coexec" for nid in splits)
    # the reshard and elision counts of the reference executor's walks on
    # the same document, which `chip_smoke.py` holds card runs to
    assert [fused_report.reshard_points, fused_report.elided] == \
        ref_counts["programs"]
    if isinstance(ref_counts["per_node"], list):
        assert [report.reshard_points, report.elided] == \
            ref_counts["per_node"]
    smoke = _chip_smoke()
    want = smoke.expected_counts(port_net.plan)
    assert (report.reshard_points, report.elided) == \
        (want["reshard"], want["elided"])
    assert (fused_report.reshard_points, fused_report.elided) == \
        smoke.fused_reshard_counts(port_net.plan)
    if not splits:
        assert port_net.to_json() == port.to_json()
