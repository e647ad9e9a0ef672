"""Decode-node plans in the port's executor against the JAX package's, on
the CPU.

`tiny_hybrid` (a Mamba2 block and an attention block) is compiled by the
JAX package; its plan puts every node on one side, so each typed axis
(head, kv-block, ssm-state) is forced onto it, with channel splits around
it so that split nodes chain into and out of the typed ones.  The port
runs the forced artifact on two CPU groups and is held against the
reference's unsplit oracle and its Pallas run (`interpret=True`) on the
reference's own weights; its reshard and elision counts against the
reference graph's.  The committed zamba2-7b artifact is checked to be what
the reference CLI writes and to decode alike in both packages; it is not
run at full width here.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro.graph.frontends import from_model
from repro.kernels import registry as jax_registry
from repro.kernels.registry import op_to_json as jax_op_to_json
from repro.runtime.executor import PlanExecutor as JaxPlanExecutor

import repro_torch
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.registry import op_to_json
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.runtime.executor import PlanExecutor

from test_torch_support import ROOT, ZAMBA_ARTIFACT, forced_split_doc

# fp32 sums in other orders through two residual blocks, and the kv-block
# split's log-sum-exp merge, which reassociates the softmax sums
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)

#: typed-axis splits forced onto tiny_hybrid (b0: in_proj -> ssm ->
#: out_proj; b1: q_proj -> attn -> o_proj -> mlp), by node id; the channel
#: splits around a typed node make it chain in and out
FORCED = {
    "head": {"b1.q_proj": 40, "b1.attn": ("head", 2), "b1.o_proj": 24},
    "kv-block": {"b1.q_proj": 40, "b1.attn": ("kv-block", 128),
                 "b1.mlp_up": 64},
    "ssm-state": {"b0.in_proj": 64, "b0.ssm": ("ssm-state", 1),
                  "b0.out_proj": 16},
    "typed-only": {"b0.ssm": ("ssm-state", 3), "b1.attn": ("kv-block", 384)},
}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    graph = from_model("tiny_hybrid", blocks=2, cache_len=512)
    return repro.compile(graph, repro.Target(device="moto2022", threads=3),
                         mode="grid", cache=tmp_path_factory.mktemp("plans"))


def _expected_counts(ref_plan):
    """(co-executed nodes, elided, reshard points) of the chained walk,
    from the reference's graph: channel and stackable typed splits leave
    group-local outputs, gathered once unless their sole consumer chains
    them; a non-stackable split (kv-block) merges its sides itself."""
    typed = {nid: d for nid, d in ref_plan.decisions_by_node.items()
             if d.axis not in ("channel", "none") and d.c_cpu and d.c_gpu}
    coexec = ref_plan.coexec_node_ids() | set(typed)
    merged = {nid for nid, d in typed.items() if not jax_registry.axis_spec(
        jax_registry.op_kind(d.op), d.axis).stackable}
    elided = ref_plan.graph_ir().elided(coexec) - merged
    return len(coexec), len(elided), len(coexec - merged - elided)


@pytest.mark.parametrize("variant", sorted(FORCED))
def test_forced_typed_split_matches_reference_oracle_and_pallas_run(
        hybrid, variant):
    doc = forced_split_doc(hybrid, FORCED[variant])
    port = repro_torch.CompiledNetwork.from_json(doc, verify=False)
    ref = repro.CompiledNetwork.from_json(doc, verify=False)
    specs = port.plan.exec_specs()
    assert [(s.unit, s.axis, s.c_fast, s.c_slow, s.node_id) for s in specs] \
        == [(s.unit, s.axis, s.c_fast, s.c_slow, s.node_id)
            for s in ref.plan.exec_specs()]

    exe = port.executor(device="cpu")
    jexe = JaxPlanExecutor(ref.plan, seed=0)
    for p, q in zip(exe.params, jexe.params):       # one set of weights
        assert (p is None) == (q is None)
        if p is not None:
            np.testing.assert_array_equal(_np(p), _np(q))

    before = (decode_attention.launches, ssd_chunk_scan.launches)
    y, report = exe.run()
    assert (decode_attention.launches, ssd_chunk_scan.launches) == before
    want = _np(jexe.run_oracle())
    assert tuple(y.shape) == want.shape == (1, 64)
    np.testing.assert_allclose(_np(y), want, **DECODE_TOL)
    np.testing.assert_allclose(_np(exe.run_oracle()), want, **DECODE_TOL)
    y_pallas, _ = JaxPlanExecutor(ref.plan, seed=0, use_pallas=True,
                                  interpret=True).run()
    np.testing.assert_allclose(_np(y), _np(y_pallas), **DECODE_TOL)

    n_coexec, n_elided, n_reshard = _expected_counts(ref.plan)
    assert report.count("coexec") == n_coexec == len(FORCED[variant])
    assert (report.elided, report.reshard_points) == (n_elided, n_reshard)
    by_id = {t.node_id: t for t in report.timings}
    for nid, share in FORCED[variant].items():
        assert by_id[nid].mode == "coexec"
        assert by_id[nid].c_fast == (share[1] if isinstance(share, tuple)
                                     else share)

    # gathering after every split: the same values, nothing elided
    y_unchained, rep = exe.run(chain=False)
    assert rep.elided == 0
    np.testing.assert_allclose(_np(y_unchained), _np(y), **DECODE_TOL)


def test_forced_chains_run_through_the_typed_nodes(hybrid):
    """q_proj -> attn (head split) -> o_proj and in_proj -> ssm
    (ssm-state) -> out_proj stay group-local end to end."""
    doc = forced_split_doc(hybrid, {**FORCED["head"], **FORCED["ssm-state"]})
    exe = repro_torch.CompiledNetwork.from_json(
        doc, verify=False).executor(device="cpu")
    _, report = exe.run()
    by_id = {t.node_id: t for t in report.timings}
    for nid in ("b1.attn", "b1.o_proj", "b0.ssm", "b0.out_proj"):
        assert by_id[nid].chained_input, nid
    for nid in ("b1.q_proj", "b1.attn", "b0.in_proj", "b0.ssm"):
        assert not by_id[nid].gathered_output, nid
    assert report.elided == 4


def test_load_params_carries_the_reference_decode_state(hybrid):
    """The stacked KV cache and the flat SSM vector load in the reference's
    layouts, and typed splits re-pack from them."""
    doc = forced_split_doc(hybrid, FORCED["kv-block"] | FORCED["ssm-state"])
    ref = repro.CompiledNetwork.from_json(doc, verify=False)
    jexe = JaxPlanExecutor(ref.plan, seed=7)
    exe = repro_torch.CompiledNetwork.from_json(
        doc, verify=False).executor(device="cpu")
    y0, _ = exe.run()
    exe.load_params([None if p is None else np.asarray(p)
                     for p in jexe.params])
    x = np.asarray(jexe.input_template())
    y, _ = exe.run(x)
    assert not torch.equal(y, y0)
    np.testing.assert_allclose(_np(y), _np(jexe.run_oracle(x)), **DECODE_TOL)
    shapes = {s.unit: tuple(p.shape) for s, p in zip(exe.specs, exe.params)
              if s.unit in ("attention", "ssm")}
    assert shapes == {"attention": (2, 512, 2, 16),
                      "ssm": (2 * 16 + 4 + 4 + 4 * 32 * 16,)}


def test_an_illegal_typed_split_fails_to_load(hybrid):
    doc = forced_split_doc(hybrid, {"b1.attn": ("head", 1)})   # GQA g = 2
    with pytest.raises(ValueError, match="granularity"):
        repro_torch.CompiledNetwork.from_json(doc)      # decoded at load
    ref = repro.CompiledNetwork.from_json(doc, verify=False)
    with pytest.raises(ValueError, match="granularity"):
        ref.plan.exec_specs()                           # decoded on use


# ------------------------------------------------- the zamba2-7b artifact
def test_zamba_artifact_is_what_the_reference_compiles(tmp_path):
    """`python -m repro plan --model zamba2-7b --blocks 9 --cache-len 4096
    --device moto2022 --threads 1 --save ...` writes exactly the committed
    file."""
    out = tmp_path / "zamba.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro", "plan", "--model", "zamba2-7b",
         "--blocks", "9", "--cache-len", "4096", "--device", "moto2022",
         "--threads", "1", "--cache-dir", str(tmp_path / "plans"),
         "--save", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert out.read_text() == ZAMBA_ARTIFACT.read_text()


def test_zamba_artifact_decodes_alike_in_both_packages():
    ref = repro.CompiledNetwork.load(ZAMBA_ARTIFACT)
    port = repro_torch.CompiledNetwork.load(ZAMBA_ARTIFACT)
    key = lambda s, codec: (s.unit, None if s.op is None else codec(s.op),
                            s.c_fast, s.c_slow, s.axis, s.node_id, s.segment)
    assert [key(s, op_to_json) for s in port.plan.exec_specs()] == \
        [key(s, jax_op_to_json) for s in ref.plan.exec_specs()]
    assert port.key == ref.key == "cfaaa870121a673ed48ca7f185f50548"
    assert port.graph.fingerprint() == ref.graph.fingerprint()
    assert port.to_json() == json.loads(ZAMBA_ARTIFACT.read_text())
    assert port.plan.coexec_node_ids() == ref.plan.coexec_node_ids()
    assert _expected_counts(ref.plan) == (19, 1, 17)
    specs = {s.node_id: s for s in port.plan.exec_specs()}
    attn = specs["b8.attn"]
    assert (attn.axis, attn.c_fast, attn.c_slow) == ("kv-block", 3072, 1024)
    assert (attn.op.H, attn.op.KV, attn.op.hd, attn.op.S) == \
        (32, 32, 112, 4096)


def test_chip_smoke_derives_the_main_paths_counts_from_the_artifacts():
    """The launch, reshard and elision counts `chip_smoke.py` asserts per
    request are derived from each artifact's specs and graph."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_counts",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    zamba = repro_torch.CompiledNetwork.load(ZAMBA_ARTIFACT).plan
    assert mod.expected_counts(zamba) == {
        "split_matmul": 39, "hadamard_matmul": 0, "decode_attention": 2,
        "ssd_chunk_scan": 8, "prefill_attention": 0, "mamba_conv_silu": 0,
        "gated_rms_norm": 0, "reshard": 17, "elided": 1}
    vgg = repro_torch.CompiledNetwork.load(mod.ARTIFACT).plan
    assert mod.expected_counts(vgg) == {
        "split_matmul": 4, "hadamard_matmul": 6, "decode_attention": 0,
        "ssd_chunk_scan": 0, "prefill_attention": 0, "mamba_conv_silu": 0,
        "gated_rms_norm": 0, "reshard": 4, "elided": 4}


def test_zamba_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    compiled = repro_torch.CompiledNetwork.load(ZAMBA_ARTIFACT)
    with pytest.raises(RuntimeError, match="CUDA"):
        compiled.executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        compiled.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanExecutor(compiled.plan)
