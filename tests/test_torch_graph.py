"""The port's graph IR and plan codec against the JAX package's: network
fingerprints, graph validation, gather elision, and a DAG plan with a
fanned-out split producer and a residual add run end to end."""
import json

import numpy as np
import pytest

import repro
from repro.core.networks import NETWORKS as JAX_NETWORKS
from repro.graph import fan_out_demo
from repro.graph.ir import Graph as JaxGraph
from repro.graph.ir import from_units as jax_from_units
from repro.runtime.executor import PlanExecutor as JaxPlanExecutor

import repro_torch
from repro_torch.core.networks import NETWORKS
from repro_torch.graph.ir import Graph, from_units

from test_torch_support import forced_split_doc


@pytest.mark.parametrize("name", sorted(JAX_NETWORKS))
def test_unit_networks_fingerprint_and_elide_like_the_reference(name):
    ours, ref = from_units(NETWORKS[name]()), jax_from_units(
        JAX_NETWORKS[name]())
    assert ours.fingerprint() == ref.fingerprint()
    assert [n.id for n in ours] == [n.id for n in ref]
    assert [ours.output_shape(n.id) for n in ours] == \
        [ref.output_shape(n.id) for n in ref]
    # every splittable node co-executed: the elision predicate agrees
    coexec = {n.id for n in ref if n.kind in ("conv", "linear")}
    assert ours.elided(coexec) == ref.elided(coexec)
    assert ours.materialization_points(coexec) == \
        ref.materialization_points(coexec)


@pytest.mark.parametrize("nodes", [
    [],                                                        # empty
    [{"id": "a", "kind": "pool", "bytes": 4, "inputs": []}],   # pool source
    [{"id": "a", "kind": "linear", "inputs": [],
      "op": {"kind": "linear", "L": 1, "C_in": 2, "C_out": 2}},
     {"id": "a", "kind": "linear", "inputs": ["a"],
      "op": {"kind": "linear", "L": 1, "C_in": 2, "C_out": 2}}],  # dup id
    [{"id": "a", "kind": "linear", "inputs": ["b"],
      "op": {"kind": "linear", "L": 1, "C_in": 2, "C_out": 2}},
     {"id": "b", "kind": "linear", "inputs": ["a"],
      "op": {"kind": "linear", "L": 1, "C_in": 2, "C_out": 2}}],  # cycle
    [{"id": "a", "kind": "conv", "inputs": [],
      "op": {"kind": "linear", "L": 1, "C_in": 2, "C_out": 2}}],  # kind
    [{"id": "a", "kind": "linear", "inputs": [],
      "op": {"kind": "linear", "L": 1, "C_in": 2, "C_out": 2}},
     {"id": "j", "kind": "add", "inputs": ["a"]}],              # add arity
])
def test_graph_validation_rejects_what_the_reference_rejects(nodes):
    doc = {"schema_version": 2, "nodes": nodes}
    with pytest.raises(ValueError):
        JaxGraph.from_json(doc)
    with pytest.raises(ValueError):
        Graph.from_json(doc)


def test_fanned_out_split_is_gathered_once_and_joined(tmp_path):
    graph, producer = fan_out_demo()
    compiled = repro.compile(graph, repro.Target(device="moto2022"),
                             mode="grid", cache=tmp_path / "plans")
    pos = {nid: i for i, nid in enumerate(compiled.plan.node_ids())}
    doc = forced_split_doc(compiled, {pos[producer]: 16, pos["left"]: 24,
                                      pos["right"]: 8})
    ref = repro.CompiledNetwork.from_json(doc, verify=False)
    port = repro_torch.CompiledNetwork.from_json(json.loads(json.dumps(doc)),
                                                 verify=False)
    assert port.graph.fingerprint() == ref.graph.fingerprint() == \
        port.provenance.network_fingerprint

    exe = port.executor(device="cpu")
    y, report = exe.run()
    # a fans out: one gather serves both consumers; left/right are
    # gathered at the add join; nothing chains
    assert (report.elided, report.reshard_points) == (0, 3)
    jexe = JaxPlanExecutor(ref.plan, seed=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jexe.run_oracle()),
                               rtol=1e-5, atol=1e-5)
    assert [t.mode for t in report.timings] == \
        ["coexec", "coexec", "coexec", "add"]
