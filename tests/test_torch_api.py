"""Loading and running artifacts in the port: the committed VGG16
artifact, the checks `CompiledNetwork` makes on load, the CUDA default of
its entry points, `save`, `dtype=`/`seed=`, the introspection the
reference offers (`units`, `decisions_by_node`, `report`, `explain`), and
`python -m repro_torch execute`."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro.analysis import errors as jax_errors
from repro.analysis import verify_plan as jax_verify_plan
from repro.api import _artifact_checksum as jax_artifact_checksum
from repro.kernels.registry import op_to_json as jax_op_to_json

import repro_torch
from repro_torch.api import Target, _artifact_checksum
from repro_torch.kernels.registry import op_to_json

from test_torch_support import ROOT, VGG16_ARTIFACT, compile_small

COMMITTED = sorted((ROOT / "src/repro_torch/artifacts").glob("*.coexec.json"))


@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    compiled = compile_small("grid", tmp_path_factory.mktemp("plans"))
    return compiled.save(tmp_path_factory.mktemp("art") / "small.json")


# ------------------------------------------------------ the VGG16 artifact
def test_vgg16_artifact_is_what_the_reference_compiles(tmp_path):
    """`python -m repro plan --network vgg16 --device moto2022 --threads 3
    --save ...` writes exactly the committed file."""
    out = tmp_path / "vgg16.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro", "plan", "--network", "vgg16",
         "--device", "moto2022", "--threads", "3", "--cache-dir",
         str(tmp_path / "plans"), "--save", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert out.read_text() == VGG16_ARTIFACT.read_text()
    # and the reference loads it with its static verifier clean
    ref = repro.CompiledNetwork.load(VGG16_ARTIFACT)
    assert not jax_errors(jax_verify_plan(ref.plan, stats=False))


def test_vgg16_artifact_decodes_alike_in_both_packages():
    ref = repro.CompiledNetwork.load(VGG16_ARTIFACT)
    port = repro_torch.CompiledNetwork.load(VGG16_ARTIFACT)
    key = lambda s, codec: (s.unit, None if s.op is None else codec(s.op),
                            s.c_fast, s.c_slow, s.node_id)
    assert [key(s, op_to_json) for s in port.plan.exec_specs()] == \
        [key(s, jax_op_to_json) for s in ref.plan.exec_specs()]
    assert port.graph.fingerprint() == ref.graph.fingerprint() == \
        port.provenance.network_fingerprint
    assert port.key == ref.key
    assert port.to_json() == json.loads(VGG16_ARTIFACT.read_text())

    coexec = port.plan.coexec_node_ids()
    assert coexec == ref.plan.coexec_node_ids()
    assert port.graph.elided(coexec) == {"n10", "n11", "n14", "n15"}
    assert port.graph.materialization_points(coexec) == \
        {"n6", "n12", "n16", "n18"}
    # the main path's kernel launches: 4 split_matmul, 6 hadamard_matmul
    from repro_torch.kernels.winograd_conv import winograd_eligible
    specs = port.plan.exec_specs()
    sides = lambda s: 2 if s.coexec else 1
    assert sum(sides(s) for s in specs if s.unit == "linear") == 4
    assert sum(sides(s) for s in specs
               if s.unit == "conv" and winograd_eligible(s.op)) == 6


# ----------------------------------------------------------------- loading
def test_a_tampered_artifact_fails_its_checksum(small_artifact, tmp_path):
    doc = json.loads(small_artifact.read_text())
    assert doc["checksum"] == _artifact_checksum(doc) == \
        jax_artifact_checksum(doc)
    doc["plan"]["schedule"][0]["decision"]["c_gpu"] += 8
    bad = tmp_path / "tampered.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="checksum"):
        repro_torch.CompiledNetwork.load(bad)


@pytest.mark.parametrize("field,value,match", [
    ("format", "something.else", "artifact"),
    ("version", 2, "version"),
])
def test_loading_checks_format_and_version(small_artifact, field, value,
                                           match):
    doc = json.loads(small_artifact.read_text())
    doc[field] = value
    with pytest.raises(ValueError, match=match):
        repro_torch.CompiledNetwork.from_json(doc)


def test_loading_recomputes_the_fingerprint_and_checks_kinds(small_artifact):
    doc = json.loads(small_artifact.read_text())
    doc["plan"]["provenance"]["network_fingerprint"] = "f" * 24
    doc["checksum"] = _artifact_checksum(doc)
    with pytest.raises(ValueError, match="fingerprint"):
        repro_torch.CompiledNetwork.from_json(doc)
    doc = json.loads(small_artifact.read_text())
    doc["plan"]["graph"] = {"schema_version": 2, "nodes": [
        {"id": f"n{i}", "kind": "pool" if e["unit"] == "pool" else "add",
         "inputs": [] if i == 0 else [f"n{i - 1}"], "bytes": 4}
        for i, e in enumerate(doc["plan"]["schedule"])]}
    doc["checksum"] = _artifact_checksum(doc)
    with pytest.raises(ValueError):
        repro_torch.CompiledNetwork.from_json(doc)


def test_target_validates_like_the_reference():
    Target(device="moto2022")
    for bad in (dict(device="iphone"), dict(device="pixel5", threads=0),
                dict(device="pixel5", mechanism="spin"),
                dict(device="pixel5", mesh="ring"),
                dict(device="pixel5", step=True)):
        with pytest.raises(ValueError):
            Target(**bad)
    assert Target.from_json(repro.Target(device="pixel5").to_json()) == \
        Target(device="pixel5")


# ------------------------------------------------------------ entry points
def test_entry_points_default_to_cuda_and_never_fall_back(small_artifact):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    compiled = repro_torch.CompiledNetwork.load(small_artifact)
    with pytest.raises(RuntimeError, match="CUDA"):
        compiled.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        compiled.profile()
    y = compiled.run(device="cpu")
    assert tuple(y.shape) == (1, 10) and y.device.type == "cpu"
    assert compiled.last_report.split_capable


def test_cli_execute_runs_an_artifact_on_the_cpu(small_artifact):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "execute", "--artifact",
         str(small_artifact), "--device", "cpu", "--per-op", "--runs", "2"],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "run 2/2: fidelity: 10 units" in proc.stdout
    assert "[09] linear 1x64->10" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "execute", "--artifact",
             str(small_artifact)],
            capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)
        assert proc.returncode == 2 and "CUDA" in proc.stderr


# ------------------------------------------- save, dtype, seed, introspection
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_load_roundtrip_with_run_equality(small_artifact, tmp_path,
                                               dtype):
    """The artifact, its provenance digest, target and schedule survive a
    save/load cycle byte for byte, and so does the run's output, in fp32
    and bf16."""
    compiled = repro_torch.CompiledNetwork.load(small_artifact)
    path = compiled.save(tmp_path / "again" / "small.coexec.json")
    assert path.read_text() == small_artifact.read_text()
    back = repro_torch.CompiledNetwork.load(path)
    assert back.key == compiled.key
    assert back.provenance == compiled.provenance
    assert back.target == compiled.target and back.mode == compiled.mode
    assert back.plan.schedule == compiled.plan.schedule

    y0 = compiled.run(device="cpu", dtype=dtype)
    y1 = back.run(device="cpu", dtype=dtype)
    assert y0.dtype == y1.dtype == getattr(torch, dtype)
    assert torch.equal(y0, y1)


def test_seed_selects_the_reference_weights(small_artifact):
    from repro.runtime.executor import PlanExecutor as JaxPlanExecutor
    compiled = repro_torch.CompiledNetwork.load(small_artifact)
    exe0 = compiled.executor(device="cpu")
    exe1 = compiled.executor(device="cpu", seed=1)
    assert exe1 is not exe0
    assert compiled.executor(device="cpu", seed=1) is exe1   # memoized
    assert compiled.executor(device="cpu", dtype=torch.float32) is exe0
    jexe = JaxPlanExecutor(repro.CompiledNetwork.load(small_artifact).plan,
                           seed=1)
    for p, q in zip(exe1.params, jexe.params):
        if p is not None:
            assert torch.equal(p, torch.tensor(np.asarray(q)))
    y0 = compiled.run(device="cpu")
    y1 = compiled.run(device="cpu", seed=1)
    assert not torch.equal(y0, y1)
    assert torch.equal(compiled.run(device="cpu", seed=1), y1)
    with pytest.raises(ValueError, match="dtype"):
        compiled.executor(device="cpu", dtype="float16")


def _decision_key(d, codec):
    return (codec(d.op), d.c_cpu, d.c_gpu, d.pred_cpu_us, d.pred_gpu_us,
            d.pred_total_us, d.axis, d.exclusive,
            None if d.tile is None else d.tile.label())


@pytest.mark.parametrize("name", [p.name for p in COMMITTED] + ["small"])
def test_introspection_agrees_with_the_reference(small_artifact, name):
    """units, decisions, decisions_by_node, report() and explain() of the
    same artifact, in both packages."""
    path = small_artifact if name == "small" else \
        next(p for p in COMMITTED if p.name == name)
    ref = repro.CompiledNetwork.load(path)
    port = repro_torch.CompiledNetwork.load(path)

    assert port.explain() == ref.explain()
    assert port.explain().endswith("verify: clean")
    assert [_decision_key(d, op_to_json) for d in port.decisions] == \
        [_decision_key(d, jax_op_to_json) for d in ref.decisions]
    assert {n: _decision_key(d, op_to_json)
            for n, d in port.decisions_by_node.items()} == \
        {n: _decision_key(d, jax_op_to_json)
         for n, d in ref.decisions_by_node.items()}
    if ref.plan.graph_json is None:
        assert [(k, p if k == "pool" else op_to_json(p))
                for k, p in port.units] == \
            [(k, p if k == "pool" else jax_op_to_json(p))
             for k, p in ref.units]
    else:
        with pytest.raises(ValueError):
            port.units
    rep, jrep = port.report(), ref.report()
    assert (rep is None) == (jrep is None)
    if rep is not None:
        fields = ("device", "threads", "baseline_us", "individual_us",
                  "end_to_end_us", "individual_speedup",
                  "end_to_end_speedup")
        assert [getattr(rep, f) for f in fields] == \
            [getattr(jrep, f) for f in fields]
        assert [_decision_key(d, op_to_json) for d in rep.decisions] == \
            [_decision_key(d, jax_op_to_json) for d in jrep.decisions]


def test_cli_execute_without_chaining_reports_no_elision(capsys):
    """`execute --no-chain` gathers after every co-executed op; the chained
    walk of the same resnet18 artifact elides 13 gathers."""
    from repro_torch.cli import main
    path = str(ROOT / "src/repro_torch/artifacts/resnet18_moto2022.coexec.json")
    assert main(["execute", "--artifact", path, "--device", "cpu",
                 "--no-warmup"]) == 0
    assert "4 reshard points (13 elided)" in capsys.readouterr().out
    assert main(["execute", "--artifact", path, "--device", "cpu",
                 "--no-chain", "--no-warmup"]) == 0
    out = capsys.readouterr().out
    assert "17 reshard points (0 elided)" in out
