"""The port's dry run (`launch.dryrun`) and its abstract inputs
(`launch.steps.input_specs`) against the reference's, on the CPU.

The reference's CI combinations (`tests/test_dryrun_small.py`) walked at
published widths on the test meshes give that test's statuses, positive
FLOPs and the reference's `model_flops_estimate`, and write their
records where they are told; a walk at published widths makes no real
tensor at all (every op result is a `FakeTensor`), so its memory does
not grow with the model.  `input_specs` gives the reference's
`jax.eval_shape` stand-ins, shape and dtype, leaf for leaf, once the
port's per-layer trees are put in the reference's stacked layout.  The
command line takes the reference's flags and exits as it does.
"""
import json
import resource

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.launch.shapes import INPUT_SHAPES as JAX_SHAPES
from repro.launch.steps import input_specs as jax_input_specs
from repro.models import build as jax_build
from repro.roofline.analysis import model_flops_estimate as jax_model_flops

from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import INPUT_SHAPES
from repro_torch.launch.steps import input_specs
from repro_torch.models import ARCH_IDS, build, params_to_reference

#: the reference's CI combinations and the statuses its test expects
CI = [("rwkv6_1b6", "decode_32k", False, "ok"),
      ("rwkv6_1b6", "long_500k", True, None),
      ("deepseek_v2_lite", "decode_32k", False, "ok"),
      ("gemma3_12b", "long_500k", False, "ok"),
      ("llama3_405b", "long_500k", False, "skipped")]


class _RealResults(TorchDispatchMode):
    """Below every fake mode: sees only ops that a fake mode passes on,
    and records the largest result that is not a fake tensor."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                self.largest = max(self.largest, t.numel() * t.element_size())
        return out


@pytest.mark.parametrize("arch,shape,multi_pod,status", CI,
                         ids=[f"{a}-{s}" for a, s, _, _ in CI])
def test_the_reference_ci_combinations_walk(arch, shape, multi_pod, status,
                                            tmp_path):
    real = _RealResults()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with real:
        rec = dryrun.lower_one(arch, shape, multi_pod=multi_pod,
                               verbose=False, extra_tag="citest",
                               test_mesh=True, report_dir=tmp_path)
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss
    mesh = "2x2x2" if multi_pod else "2x4"
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, mesh)
    if status is not None:
        assert rec["status"] == status
    if rec["status"] == "skipped":
        assert (tmp_path / f"{arch}_{shape}_{mesh}.json").exists()
        return
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    cfg, _ = jax_build(arch)
    assert rec["model_flops"] == jax_model_flops(cfg, JAX_SHAPES[shape])
    assert rec["chips"] == 8 and rec["collective_bytes"] is None
    assert rec["bottleneck"] in ("compute", "memory")
    assert rec["peak_memory_bytes"] > 0 and rec["walk_s"] >= 0
    saved = json.loads((tmp_path / f"{arch}_{shape}_{mesh}_citest.json")
                       .read_text())
    assert saved == rec
    assert real.largest <= 1 << 20          # no real tensor over 1 MB
    assert grown_kb < 2 << 20               # < 2 GB, for a 10-60 GB model


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counted_as_plain_names_the_ssd_scan_of_mamba2_only(arch):
    """A walk on fake CPU tensors takes `ssd_chunk_scan`'s CPU branch, so
    a Mamba2 model's record, and only its, names that kernel."""
    cfg, _ = build(arch)
    want = ["ssd_chunk_scan"] if cfg.ssm_kind == "mamba2" else []
    assert dryrun.counted_as_plain(cfg) == want
    assert bool(want) == (arch == "zamba2_7b")


def _shapes(tree):
    """[(shape, dtype name)] of a tree's leaves in jax's flatten order."""
    return [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in jax.tree.leaves(tree)]


def _stacked(tree):
    """A port cache tree in the reference's layout, as shapes: per-layer
    lists stacked over a leading axis (a transformer's prologue stays a
    list of pairs, and each pattern entry a pair of stacked leaves)."""
    def stack(xs):
        first = xs[0]
        if isinstance(first, (list, tuple)) and not torch.is_tensor(first):
            return stack([stack(x) for x in xs]) if isinstance(
                first, list) else tuple(stack(list(p)) for p in zip(*xs))
        return jax.ShapeDtypeStruct((len(xs),) + tuple(first.shape),
                                    _np_dtype(first.dtype))

    if "prologue" in tree:
        return {"prologue": [tuple(_sds(t) for t in pair)
                             for pair in tree["prologue"]],
                "pattern": [tuple(stack(list(p)) for p in zip(*reps))
                            for reps in tree["pattern"]]}
    return {k: stack(v) if isinstance(v, list) else _sds(v)
            for k, v in tree.items()}


def _np_dtype(dtype):
    return jax.numpy.dtype(str(dtype).split(".")[-1])


def _sds(t):
    return jax.ShapeDtypeStruct(tuple(t.shape), _np_dtype(t.dtype))


def _fake_leaves(tree):
    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_references(arch):
    cfg, model = build(arch)
    jcfg, jmodel = jax_build(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        mode = FakeTensorMode()
        mine = input_specs(cfg, model, INPUT_SHAPES[name], mode)
        ref = jax_input_specs(jcfg, jmodel, JAX_SHAPES[name])
        assert set(mine) == set(ref), name
        assert all(isinstance(x, FakeTensor) for x in _fake_leaves(mine))
        with mode:
            params = params_to_reference(mine.pop("params"))
            if "opt_state" in mine:
                opt = mine.pop("opt_state")
                assert _shapes(params_to_reference(opt.mu)) == _shapes(
                    ref["opt_state"].mu)
                assert _shapes(params_to_reference(opt.nu)) == _shapes(
                    ref["opt_state"].nu)
                assert _shapes(opt.step) == _shapes(ref["opt_state"].step)
        assert _shapes(params) == _shapes(ref["params"]), name
        if "cache" in mine:
            assert _shapes(_stacked(mine.pop("cache"))) == _shapes(
                ref["cache"]), name
        rest = {k: v for k, v in ref.items()
                if k not in ("params", "opt_state", "cache")}
        assert _shapes(mine) == _shapes(rest), name


def test_the_command_line_walks_and_exits_as_the_reference(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    monkeypatch.setattr(dryrun, "REPORT_DIR", tmp_path)
    monkeypatch.setattr(dryrun.lower_one, "__kwdefaults__", dict(
        dryrun.lower_one.__kwdefaults__, report_dir=tmp_path))
    assert dryrun.main(["--arch", "llama3_405b", "--shape", "long_500k",
                        "--both-meshes", "--tag", "t"]) == 0
    out = capsys.readouterr().out
    assert out.count("SKIP llama3_405b x long_500k") == 2
    assert "all combinations walked" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "llama3_405b_long_500k_16x16.json",
        "llama3_405b_long_500k_2x16x16.json"]

    def broken(*args, **kwargs):
        raise RuntimeError("no")

    monkeypatch.setattr(dryrun, "lower_one", broken)
    assert dryrun.main(["--arch", "codeqwen15_7b", "--shape",
                        "train_4k"]) == 1
    assert "1 FAILURES" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "no_such_arch"])
