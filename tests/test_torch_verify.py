"""The port's static verifier and strict load against the reference's.

The reference's mutation catalog (`tests/test_analysis.py`) is applied to
the same known-good plan documents (a resnet18 unit chain, a tiny_decoder
with typed splits, a VGG16 plan with a tuned tile) and every mutation must
draw the same error rule ids from the port's `verify_plan` as from the
reference's, and be refused by the port's strict loaders with them.
Three tampered copies of the committed VGG16 artifact (a bogus tile, a
relabelled segment, a pool merged into a fused segment) are refused with
the reference's rule ids and load with `verify=False`.  Every committed
artifact verifies clean in both packages, and `python -m repro_torch
verify` keeps the reference's exit codes without importing jax.
"""
import copy
import dataclasses
import json
import subprocess
import sys

import pytest

import repro
from repro.analysis import RULES as JAX_RULES
from repro.analysis import VerificationError as JaxVerificationError
from repro.analysis import errors as jax_errors
from repro.analysis import plan_stats as jax_plan_stats
from repro.analysis import verify_artifact as jax_verify_artifact
from repro.analysis import verify_path as jax_verify_path
from repro.analysis import verify_plan as jax_verify_plan
from repro.core.networks import NETWORKS
from repro.graph import from_model
from repro.graph.ir import from_units
from repro.kernels import registry as jax_registry
from repro.runtime.plan import CoexecPlan as JaxPlan
from repro.runtime.plan import PlanProvenance as JaxProvenance

import repro_torch
from repro_torch.analysis import (RULES, VerificationError, errors,
                                  plan_stats, verify_path, verify_plan)
from repro_torch.api import _artifact_checksum
from repro_torch.kernels import registry
from repro_torch.runtime.plan import CoexecPlan

from test_analysis import MUTATIONS, _decisions, _forced_plan
from test_torch_support import ROOT, VGG16_ARTIFACT

ARTIFACTS = sorted((ROOT / "src/repro_torch/artifacts").glob("*.json"))


# ------------------------------------------------------ known-good plans

@pytest.fixture(scope="module")
def base_docs():
    """The reference's known-good documents (`tests/test_analysis.py`
    fixtures), built with the reference's planner helpers."""
    g = from_units(NETWORKS["resnet18"]())
    resnet = _forced_plan(g, *_decisions(g)).to_json()
    g = from_model("tiny_decoder", cache_len=512)
    decoder = _forced_plan(g, *_decisions(g, typed=True)).to_json()
    # a legal non-default tile on the first linear decision that has one
    g = from_units(NETWORKS["vgg16"]())
    decisions, opaque = _decisions(g)
    for n in g:
        if n.kind != "linear":
            continue
        spec = jax_registry.tile_spec("linear")
        default = spec.default_config(n.op)
        alt = next((c for c in spec.configs(n.op) if c != default), None)
        if alt is not None:
            decisions[n.id] = dataclasses.replace(decisions[n.id], tile=alt)
            break
    plan = _forced_plan(g, decisions, opaque)
    tuned = JaxPlan(
        provenance=dataclasses.replace(plan.provenance, tune="tune-v1.k1"),
        schedule=plan.schedule, graph_json=plan.graph_json,
        segments=plan.segments).to_json()
    assert any("tile" in e.get("decision", {}) for e in tuned["schedule"])
    return {"resnet": resnet, "decoder": decoder, "tuned": tuned}


def _rules(diags):
    return {d.rule for d in errors(diags)}


def _jax_rules(diags):
    return {d.rule for d in jax_errors(diags)}


def test_rules_are_the_reference_rules():
    assert RULES == JAX_RULES


def test_fresh_plans_verify_clean_and_account_alike(base_docs):
    for name, doc in base_docs.items():
        key = JaxProvenance.from_json(doc["provenance"]).key
        diags = verify_plan(copy.deepcopy(doc), expect_key=key)
        assert not errors(diags), (name, [str(d) for d in errors(diags)])
        info = [str(d) for d in diags if d.rule == "resource.accounting"]
        want = [str(d) for d in jax_verify_plan(copy.deepcopy(doc),
                                                expect_key=key)
                if d.rule == "resource.accounting"]
        assert info == want and len(info) == 1, name
        assert dataclasses.asdict(plan_stats(copy.deepcopy(doc))) == \
            dataclasses.asdict(jax_plan_stats(copy.deepcopy(doc)))


# ------------------------------------------------------- mutation catalog

@pytest.mark.parametrize("name,mutate,expected", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_catalog_mutation_is_refused_with_the_reference_rule(
        base_docs, name, mutate, expected):
    """For every known-good plan the mutation applies to: the same error
    rules in both verifiers (one of them the catalog's), a strict load
    refused with them, as a plan and as an artifact, and `verify=False`
    loading the plan anyway."""
    applied = 0
    for plan_name, base in base_docs.items():
        doc = copy.deepcopy(base)
        if not mutate(doc):
            continue                        # no site in this plan
        applied += 1
        expect = (JaxProvenance.from_json(base["provenance"]).key
                  if name == "provenance-digest" else None)
        got = _rules(verify_plan(copy.deepcopy(doc), expect_key=expect))
        want = _jax_rules(jax_verify_plan(copy.deepcopy(doc),
                                          expect_key=expect))
        assert got == want, (plan_name, got, want)
        assert got & expected, (plan_name, got, expected)
        if name == "provenance-digest":
            continue                        # no cache filename on load
        with pytest.raises(VerificationError) as ei:
            CoexecPlan.from_json(copy.deepcopy(doc))
        assert _rules(ei.value.diagnostics) == want, plan_name
        art = {"format": "repro.compiled_network", "version": 1,
               "mode": "predicted",
               "target": repro_torch.Target(device="moto2022").to_json(),
               "plan": copy.deepcopy(doc)}
        art["checksum"] = _artifact_checksum(art)
        with pytest.raises(VerificationError) as ei:
            repro_torch.CompiledNetwork.from_json(art)
        assert _rules(ei.value.diagnostics) == want, plan_name
        loose = CoexecPlan.from_json(copy.deepcopy(doc), verify=False)
        assert loose.schedule == doc["schedule"]
    assert applied, f"{name} applies to none of the plans"


def test_strict_load_round_trips_a_clean_plan(base_docs, tmp_path):
    for doc in base_docs.values():
        plan = CoexecPlan.from_json(copy.deepcopy(doc))
        assert plan.to_json() == doc
        path = tmp_path / "plan.json"
        plan.save(path)
        assert path.read_text() == JaxPlan.from_json(
            copy.deepcopy(doc)).dumps()
        assert CoexecPlan.load(path).to_json() == doc
        assert CoexecPlan.loads(plan.dumps()).to_json() == doc


# ------------------------------------------ tampered VGG16 artifacts

def _tamper_tile(doc, tile):
    doc["plan"]["schedule"][0]["decision"]["tile"] = tile


def _relabel_first_segments(doc):
    segs = doc["plan"]["segments"]
    assert segs[0]["nodes"] == ["n0"] and segs[1]["nodes"] == ["n1"]
    doc["plan"]["segments"] = [{"kind": "fused", "nodes": ["n0", "n1"]}] \
        + segs[2:]


def _merge_pool_into_fused(doc):
    segs = doc["plan"]["segments"]
    k = next(i for i, s in enumerate(segs) if s["nodes"] == ["n5"])
    assert segs[k]["kind"] == "pool" and segs[k + 1]["kind"] == "fused" \
        and segs[k + 1]["nodes"] == ["n6"]
    segs[k:k + 2] = [{"kind": "fused", "nodes": ["n5", "n6"]}]


TAMPERED = [
    ("bogus-tile", lambda d: _tamper_tile(d, {"bogus": 8}),
     {"tile.legality"}),
    ("misaligned-tile",
     lambda d: _tamper_tile(d, {"bm": 7, "bn": 128, "bk": 128}),
     {"tile.legality"}),
    ("segments-relabelled", _relabel_first_segments,
     {"segment.mismatch", "segment.gather"}),
    ("pool-merged-into-fused", _merge_pool_into_fused,
     {"segment.mismatch", "segment.gather"}),
]


@pytest.mark.parametrize("name,tamper,rules", TAMPERED,
                         ids=[t[0] for t in TAMPERED])
def test_tampered_vgg16_artifact_is_refused_like_the_reference(
        tmp_path, name, tamper, rules):
    doc = json.loads(VGG16_ARTIFACT.read_text())
    tamper(doc)
    doc["checksum"] = _artifact_checksum(doc)       # a consistent file
    path = tmp_path / f"{name}.coexec.json"
    path.write_text(json.dumps(doc, indent=1))

    want = _jax_rules(jax_verify_artifact(copy.deepcopy(doc)))
    assert want == rules
    with pytest.raises(JaxVerificationError):
        repro.CompiledNetwork.load(path)
    with pytest.raises(VerificationError) as ei:
        repro_torch.CompiledNetwork.load(path)
    assert _rules(ei.value.diagnostics) == want
    with pytest.raises(VerificationError) as ei:
        CoexecPlan.from_json(copy.deepcopy(doc["plan"]))
    assert _rules(ei.value.diagnostics) == want

    loose = repro_torch.CompiledNetwork.load(path, verify=False)
    assert loose.key == repro.CompiledNetwork.load(path,
                                                   verify=False).key
    assert loose.to_json() == doc


def test_artifact_faults_carry_artifact_rules():
    """Format, version and checksum faults raise with the reference's
    `artifact.*` rules, whether or not the plan is verified."""
    doc = json.loads(VGG16_ARTIFACT.read_text())
    for field, value, rule in (("format", "x.y", "artifact.format"),
                               ("version", 2, "artifact.format"),
                               ("mode", "tampered", "artifact.checksum")):
        bad = dict(doc, **{field: value})
        want = _jax_rules(jax_verify_artifact(bad))
        assert rule in want
        for verify in (True, False):
            with pytest.raises(VerificationError) as ei:
                repro_torch.CompiledNetwork.from_json(bad, verify=verify)
            assert _rules(ei.value.diagnostics) == want


# ----------------------------------------------------- committed artifacts

@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name)
def test_committed_artifact_verifies_clean_in_both_packages(path):
    kind, diags = verify_path(path, stats=True)
    jkind, jdiags = jax_verify_path(path, stats=True)
    portfolio = path.name.endswith(".portfolio.json")
    assert kind == jkind == ("portfolio" if portfolio else "artifact")
    assert not errors(diags) and not jax_errors(jdiags)
    assert [str(d) for d in diags] == [str(d) for d in jdiags]
    load = (repro_torch.PlanPortfolio.load if portfolio
            else repro_torch.CompiledNetwork.load)
    assert load(path).to_json() == json.loads(path.read_text())


def test_tile_table_is_the_reference_table():
    """The TPU tile contract the verifier checks: the same legal grid and
    default for ops of every kind, in both packages."""
    cases = [{"kind": "linear", "L": 1, "C_in": 25088, "C_out": 4096},
             {"kind": "linear", "L": 1, "C_in": 64, "C_out": 10},
             {"kind": "conv", "H_in": 56, "W_in": 56, "C_in": 64,
              "C_out": 128, "K": 3, "S": 1},
             {"kind": "conv", "H_in": 7, "W_in": 7, "C_in": 512,
              "C_out": 512, "K": 3, "S": 1},
             {"kind": "attention", "H": 32, "S": 4096, "KV": 8, "hd": 128,
              "window": 0},
             {"kind": "ssm", "T": 512, "H": 8, "hd": 64, "N": 64}]
    for d in cases:
        op, jop = registry.op_from_json(d), jax_registry.op_from_json(d)
        kind = registry.op_kind(op)
        for preserve in (True, False):
            got = [c.label() for c in registry.tile_spec(kind).configs(
                op, preserve_numerics=preserve)]
            want = [c.label() for c in jax_registry.tile_spec(kind).configs(
                jop, preserve_numerics=preserve)]
            assert got == want, d
        assert registry.default_tile(op).label() == \
            jax_registry.default_tile(jop).label()
        assert registry.tile_extents(op) == jax_registry.tile_extents(jop)
    assert (registry.TILE_SUBLANE, registry.TILE_LANE,
            registry.TILE_VMEM_BUDGET, registry.KERNEL_TILE_VERSION) == \
        (jax_registry.TILE_SUBLANE, jax_registry.TILE_LANE,
         jax_registry.TILE_VMEM_BUDGET, jax_registry.KERNEL_TILE_VERSION)


def test_decisions_decode_tiles_like_the_reference(base_docs):
    plan = CoexecPlan.from_json(copy.deepcopy(base_docs["tuned"]))
    ref = JaxPlan.from_json(copy.deepcopy(base_docs["tuned"]))
    got = {nid: d.tile.label() for nid, d in plan.decisions_by_node.items()
           if d.tile is not None}
    want = {nid: d.tile.label() for nid, d in ref.decisions_by_node.items()
            if d.tile is not None}
    assert got == want and len(got) == 1
    from repro.runtime.plan import spec_label as jax_spec_label
    from repro_torch.runtime.plan import spec_label
    assert [spec_label(s) for s in plan.exec_specs()] == \
        [jax_spec_label(s) for s in ref.exec_specs()]


# -------------------------------------------------------------------- CLI

def test_cli_verify_never_imports_jax(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.cli import main\n"
        f"assert main(['verify', {str(VGG16_ARTIFACT)!r}]) == 0\n"
        "assert main(['verify', '--all-artifacts']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('verify jax-free')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=180,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "verify jax-free" in out.stdout


def test_cli_verify_exit_codes(tmp_path, base_docs, capsys):
    from repro.cli import main as jax_main
    from repro_torch.cli import main
    good = tmp_path / "good.json"
    good.write_text(json.dumps(base_docs["resnet"]))
    bad_doc = copy.deepcopy(base_docs["resnet"])
    assert {m[0]: m[1] for m in MUTATIONS}["boundary-flip"](bad_doc)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(bad_doc))

    for entry in (main, jax_main):
        assert entry(["verify", str(good)]) == 0
        out = capsys.readouterr().out
        assert "ok" in out and "plan" in out
        assert entry(["verify", str(bad)]) == 1
        out = capsys.readouterr().out
        assert "FAIL" in out and "axis.shares" in out
        assert entry(["verify"]) == 2
        capsys.readouterr()
        assert entry(["verify", str(good), "-v"]) == 0
        assert "resource.accounting" in capsys.readouterr().out

    assert main(["verify", "--all-artifacts"]) == 0
    out = capsys.readouterr().out
    assert f"verified {len(ARTIFACTS)} artifact(s): 0 error(s)" in out

    # a portfolio document without version, entries or checksum fails
    portfolio = tmp_path / "portfolio.json"
    portfolio.write_text(json.dumps({"format": "repro.plan_portfolio"}))
    assert main(["verify", str(portfolio)]) == 1
    out = capsys.readouterr().out
    assert "FAIL portfolio" in out and "artifact.format" in out
