"""`repro_torch.compile` and `python -m repro_torch plan` against the
reference: the five committed artifacts reproduced byte for byte at the
default predictor sizes, the plan key and predictor checksum of both
planning modes, the plan cache shared both ways, the errors `compile`
raises, and the CLI round trip with jax and `repro` kept from import."""
import dataclasses
import json

import pytest

import repro
from repro.core.types import ConvOp as JaxConvOp
from repro.core.types import LinearOp as JaxLinearOp
from repro.graph.frontends import from_model as jax_from_model

import repro_torch
from repro_torch.core.types import ConvOp, LinearOp
from repro_torch.graph.frontends import from_model

from test_torch_support import ROOT, blocked_cli, small_units

ARTIFACTS = ROOT / "src/repro_torch/artifacts"

#: each committed artifact: (network, from_model kwargs or None, threads)
COMMITTED = {
    "vgg16_moto2022": ("vgg16", None, 3),
    "resnet18_moto2022": ("resnet18", None, 3),
    "resnet34_moto2022": ("resnet34", None, 3),
    "inception_v3_moto2022": ("inception_v3", None, 3),
    "zamba2-7b_b9_s4096_moto2022_t1": ("zamba2-7b",
                                       dict(blocks=9, cache_len=4096), 1),
}

SMALL = dict(samples=120, estimators=25)


@pytest.fixture(scope="session")
def predictor_cache(tmp_path_factory):
    """One predictor cache for the file: the artifacts train two bundles
    at the defaults (threads 3 linear+conv, threads 1 with attention and
    ssm) and load them afterwards."""
    return tmp_path_factory.mktemp("port_predictors")


def _network(name, kwargs, make=from_model):
    return make(name, **kwargs) if kwargs else name


@pytest.mark.parametrize("stem", sorted(COMMITTED))
def test_compile_reproduces_the_committed_artifact(stem, predictor_cache,
                                                   tmp_path):
    name, kwargs, threads = COMMITTED[stem]
    target = repro_torch.Target(device="moto2022", threads=threads)
    compiled = repro_torch.compile(_network(name, kwargs), target,
                                   cache=tmp_path / "plans",
                                   predictor_cache=predictor_cache)
    want = json.loads((ARTIFACTS / f"{stem}.coexec.json").read_text())
    assert not compiled.from_cache
    assert compiled.to_json() == want          # checksum included
    assert compiled.key == repro_torch.CompiledNetwork.from_json(want).key
    again = repro_torch.compile(_network(name, kwargs), target,
                                cache=tmp_path / "plans",
                                predictor_cache=predictor_cache)
    assert again.from_cache and again.to_json() == want
    saved = compiled.save(tmp_path / "out.json")
    assert saved.read_bytes() == (ARTIFACTS / f"{stem}.coexec.json"
                                  ).read_bytes()


def _port_units():
    """`small_units()` as the port's ops."""
    to = {"conv": ConvOp, "linear": LinearOp}
    return [(k, p if k == "pool" else to[k](**dataclasses.asdict(p)))
            for k, p in small_units()]


#: inputs compiled by both packages: label -> (port input, reference input)
INPUTS = {
    "resnet18": lambda: ("resnet18", "resnet18"),
    "tiny_hybrid": lambda: ("tiny_hybrid", "tiny_hybrid"),
    "tiny_decoder x3": lambda: (
        from_model("tiny_decoder", blocks=3, cache_len=512),
        jax_from_model("tiny_decoder", blocks=3, cache_len=512)),
    "units": lambda: (_port_units(), small_units()),
    "ops": lambda: (
        [LinearOp(50, 768, 3072), ConvOp(28, 28, 64, 96, 3, 1)],
        [JaxLinearOp(50, 768, 3072), JaxConvOp(28, 28, 64, 96, 3, 1)]),
}


@pytest.mark.parametrize("mode", ["predicted", "grid"])
@pytest.mark.parametrize("label", sorted(INPUTS))
def test_plan_key_and_checksum_equal_the_reference(label, mode, tmp_path):
    port_in, jax_in = INPUTS[label]()
    kw = SMALL if mode == "predicted" else {}
    target = dict(device="pixel4", threads=2, mechanism="event", step=16)
    got = repro_torch.compile(port_in, repro_torch.Target(**target),
                              mode=mode, cache=tmp_path / "port", **kw)
    want = repro.compile(jax_in, repro.Target(**target), mode=mode,
                         cache=tmp_path / "jax", **kw)
    assert got.key == want.key
    assert got.provenance.predictor_checksum == \
        want.provenance.predictor_checksum
    assert (got.provenance.planner, bool(got.predictors)) == \
        (want.provenance.planner, bool(want.predictors))
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_plan_cache_either_package_wrote_warm_hits_in_the_other(
        writer, tmp_path):
    target = dict(device="moto2022", threads=3)
    compilers = {"reference": (repro.compile, repro.Target),
                 "port": (repro_torch.compile, repro_torch.Target)}
    first = compilers[writer]
    second = compilers["port" if writer == "reference" else "reference"]
    for mode, kw in (("predicted", SMALL), ("grid", {})):
        a = first[0]("resnet18", first[1](**target), mode=mode,
                      cache=tmp_path, **kw)
        b = second[0]("resnet18", second[1](**target), mode=mode,
                      cache=tmp_path, **kw)
        assert not a.from_cache and b.from_cache
        assert a.to_json() == b.to_json()
    assert len(list(tmp_path.glob("*.json"))) == 2


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.mark.parametrize("case", [
    "unknown name", "empty", "bad elements", "bad mode", "bad target",
    "bucket in grid mode", "bucket on ops", "predictors in grid mode",
    "predictors for another device"])
def test_compile_errors_are_the_reference_errors(case, tmp_path):
    def call(pkg, ops, units):
        t = pkg.Target(device="moto2022")
        c = str(tmp_path / pkg.__name__)
        return {
            "unknown name": lambda: pkg.compile("resnet19", t, cache=c),
            "empty": lambda: pkg.compile([], t, cache=c),
            "bad elements": lambda: pkg.compile([1, 2], t, cache=c),
            "bad mode": lambda: pkg.compile("resnet18", t, mode="oracle"),
            "bad target": lambda: pkg.compile("resnet18", "moto2022"),
            "bucket in grid mode": lambda: pkg.compile(
                "resnet18", t, mode="grid", bucket="b1s128", cache=c),
            "bucket on ops": lambda: pkg.compile(ops, t, bucket="b1",
                                                 cache=c),
            "predictors in grid mode": lambda: pkg.compile(
                units, t, mode="grid", predictors=(None, None), cache=c),
            "predictors for another device": lambda: pkg.compile(
                units, t, cache=c, predictors=pkg.compile(
                    units, pkg.Target(device="pixel5"), cache=c,
                    **SMALL).predictors),
        }[case]()
    got_type, got = _error(lambda: call(
        repro_torch, [LinearOp(1, 8, 8)], _port_units()))
    want_type, want = _error(lambda: call(
        repro, [JaxLinearOp(1, 8, 8)], small_units()))
    assert got_type is want_type
    assert got == want.replace("repro.graph.Graph", "repro_torch.graph.Graph"
                               ).replace("repro.Target", "repro_torch.Target")


def test_tune_raises_not_implemented_naming_the_roadmap_item(tmp_path):
    # the autotuner is ported (ROADMAP Queue 1 item 4): it measures on the
    # card, so a host without CUDA refuses, naming CUDA, before anything
    # is planned or written
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.compile("resnet18", repro_torch.Target(device="moto2022"),
                            cache=tmp_path, tune=True,
                            tune_cache=tmp_path / "tune")
    assert not list(tmp_path.iterdir())


def test_available_networks_are_the_reference_names():
    assert repro_torch.available_networks() == repro.api.available_networks()
    assert {"compile", "available_networks"} <= set(repro_torch.__all__)


def test_target_validates_against_the_simulator_tables():
    from repro_torch.core.simulator.devices import DEVICES
    from repro_torch.core.sync import SyncMechanism
    for device in DEVICES:
        assert repro_torch.Target(device=device).device == device
    t = repro_torch.Target(device="pixel5",
                           mechanism=SyncMechanism.EVENT)
    assert t.mechanism == "event" and t.sync_mechanism is SyncMechanism.EVENT
    for bad in (dict(device="pixel9"), dict(device="pixel5",
                                            mechanism="poll")):
        assert _error(lambda: repro_torch.Target(**bad)) == \
            _error(lambda: repro.Target(**bad))


@pytest.mark.parametrize("stem", ["vgg16_moto2022",
                                  "zamba2-7b_b9_s4096_moto2022_t1"])
def test_cli_plan_saves_the_committed_artifact_byte_for_byte(
        stem, predictor_cache, tmp_path):
    net = (["--network", "vgg16", "--threads", "3"] if stem.startswith("vgg")
           else ["--model", "zamba2-7b", "--blocks", "9", "--cache-len",
                 "4096", "--threads", "1"])
    out = tmp_path / "artifact.json"
    args = ["plan", *net, "--device", "moto2022", "--cache-dir",
            str(tmp_path / "plans"), "--predictor-cache",
            str(predictor_cache), "--save", str(out)]
    proc = blocked_cli(args, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "cache MISS (compiled)" in proc.stdout
    assert out.read_bytes() == (ARTIFACTS / f"{stem}.coexec.json"
                                ).read_bytes()
    proc = blocked_cli(args, tmp_path)
    assert proc.returncode == 0 and "cache HIT" in proc.stdout


@pytest.mark.parametrize("args, message", [
    (["--network", "resnet18", "--tune"], "needs CUDA"),
    (["--network", "resnet19"], "unknown network 'resnet19'"),
])
def test_cli_plan_refuses_bad_input_with_exit_2(args, message, tmp_path):
    proc = blocked_cli(["plan", *args, "--cache-dir", str(tmp_path)], tmp_path)
    assert proc.returncode == 2
    assert message in proc.stderr and "Traceback" not in proc.stderr
