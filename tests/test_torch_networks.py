"""The paper's other three networks on the port's path, on the CPU.

resnet18, resnet34 and inception_v3 (`repro.core.networks`) compiled by
the JAX package for the simulated moto2022 phone (3 threads) are committed
as artifacts.  Each must be what `python -m repro plan ... --save` writes,
decode alike in both packages, and run through both of the port's walks
on two CPU groups to the reference's `run_oracle` on the same seeded
parameters, with the launch, reshard, elision and sync counts
`chip_smoke.py` holds the card to.
"""
import importlib.util
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro.kernels.registry import op_to_json as jax_op_to_json
from repro.runtime.executor import PlanExecutor as JaxPlanExecutor

import repro_torch
from repro_torch.kernels.registry import op_to_json

from test_torch_support import ROOT

ARTIFACTS = ROOT / "src/repro_torch/artifacts"

#: per network: (nodes, co-executed, elided, segments, fused segments) of
#: the plan, and per request of the chained walks on two groups the
#: launches (split_matmul, hadamard_matmul), reshard points, and syncs of
#: the per-node and the fused walk
NETWORKS = {
    "resnet18": ((23, 17, 13, 10, 4), (1, 0), 4, (24, 10)),
    "resnet34": ((39, 33, 29, 10, 4), (1, 0), 4, (40, 10)),
    "inception_v3": ((109, 93, 25, 84, 68), (1, 2), 68, (110, 84)),
}

#: both walks against the reference's oracle, relative to the largest
#: |oracle|: the split and unsplit convs sum fp32 in other orders (and
#: inception's n5 takes Winograd, which reassociates them)
E2E_RTOL = 2e-5


def _artifact(net):
    return ARTIFACTS / f"{net}_moto2022.coexec.json"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_networks",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_artifact_is_what_the_reference_compiles(tmp_path, net):
    """`python -m repro plan --network <net> --device moto2022 --threads 3
    --save ...` writes exactly the committed file."""
    out = tmp_path / f"{net}.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro", "plan", "--network", net,
         "--device", "moto2022", "--threads", "3", "--cache-dir",
         str(tmp_path / "plans"), "--save", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert out.read_text() == _artifact(net).read_text()


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_artifact_decodes_alike_in_both_packages(net):
    ref = repro.CompiledNetwork.load(_artifact(net))
    port = repro_torch.CompiledNetwork.load(_artifact(net))
    key = lambda s, codec: (s.unit, None if s.op is None else codec(s.op),
                            s.pool_bytes, s.c_fast, s.c_slow, s.axis,
                            s.node_id, s.segment)
    assert [key(s, op_to_json) for s in port.plan.exec_specs()] == \
        [key(s, jax_op_to_json) for s in ref.plan.exec_specs()]
    assert port.key == ref.key
    assert port.graph.fingerprint() == ref.graph.fingerprint() == \
        port.provenance.network_fingerprint
    assert port.to_json() == json.loads(_artifact(net).read_text())

    coexec = port.plan.coexec_node_ids()
    assert coexec == ref.plan.coexec_node_ids()
    elided = port.graph.elided(coexec)
    assert elided == ref.graph.elided(coexec)
    parts = port.plan.segment_partition()
    assert [(s.kind, s.node_ids) for s in parts] == \
        [(s.kind, s.node_ids) for s in ref.plan.segment_partition()]
    assert (len(port.graph), len(coexec), len(elided), len(parts),
            sum(s.kind == "fused" for s in parts)) == NETWORKS[net][0]


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_chip_smoke_derives_the_counts(net):
    mod = _chip_smoke()
    path = {p[0]: p[1] for p in mod.PATHS}[net]
    assert path == _artifact(net)
    _, (n_split, n_hadamard), reshard, _ = NETWORKS[net]
    elided = NETWORKS[net][0][2]
    plan = repro_torch.CompiledNetwork.load(path).plan
    assert mod.expected_counts(plan) == {
        "split_matmul": n_split, "hadamard_matmul": n_hadamard,
        "decode_attention": 0, "ssd_chunk_scan": 0, "prefill_attention": 0,
        "mamba_conv_silu": 0, "gated_rms_norm": 0, "reshard": reshard,
        "elided": elided}


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_both_walks_match_the_reference_oracle(net):
    """Per-node and fused walks on two CPU groups against the reference's
    unsplit oracle on the same seeded weights and input; the fused walk
    bit-identical to the per-node one, with its counts."""
    ref = repro.CompiledNetwork.load(_artifact(net))
    jexe = JaxPlanExecutor(ref.plan, seed=0)
    x = np.asarray(jexe.input_template())
    want = np.asarray(jexe.run_oracle())

    exe = repro_torch.CompiledNetwork.load(_artifact(net)).executor(
        device="cpu")
    np.testing.assert_array_equal(exe.input_template().numpy(), x)
    y, rep = exe.run(x)
    y_fused, rep_fused = exe.run(x, fused=True)
    assert y.shape == want.shape == (1, 1000)
    scale = float(np.abs(want).max())
    err = float(np.abs(y.numpy() - want).max())
    assert err <= E2E_RTOL * scale, (err, scale)
    assert torch.equal(y_fused, y)

    (_, n_coexec, n_elided, _, _), _, reshard, syncs = NETWORKS[net]
    assert rep.count("coexec") == n_coexec
    for r in (rep, rep_fused):
        assert (r.reshard_points, r.elided) == (reshard, n_elided)
    assert (rep.sync_points, rep_fused.sync_points) == syncs
