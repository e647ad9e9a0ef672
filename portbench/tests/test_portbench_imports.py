"""The whole-name import check, and what the harness and the references
import."""
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.run import forbidden_modules


@pytest.mark.parametrize("name,bad", [
    ("repro_torch", False), ("repro_torch.runtime.executor", False),
    ("reprolib", False), ("jaxtyping", False),
    ("repro", True), ("repro.models", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True)])
def test_whole_top_level_names(name, bad):
    assert (forbidden_modules([name]) == [name]) is bad


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted(sys.modules)))"],
        capture_output=True, text=True, check=True, cwd=manifest.ROOT,
        env={"PYTHONPATH": f"{manifest.ROOT / 'src'}:{manifest.ROOT}",
             "PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_the_harness_and_drivers_load_no_jax():
    mods = _loaded(
        "import portbench.run, portbench.trace, portbench.control\n"
        "from portbench import manifest\n"
        "for c in manifest.load()['configs']:\n"
        "    manifest.driver(manifest.config(c['name'])['driver'])"
        ".Driver\n"
        "import repro_torch\n"
        "for m in manifest.load()['end_to_end'] + "
        "manifest.load()['per_layer']:\n"
        "    manifest.reader(m['name'])")
    assert forbidden_modules(mods) == []
    assert "repro_torch" in mods


def test_the_references_load_nothing_of_the_program():
    mods = _loaded("import portbench.reference.plan_graph, "
                   "portbench.reference.precision, "
                   "portbench.compare, portbench.counts")
    assert forbidden_modules(mods) == []
    assert not any(m.split(".")[0] == "repro_torch" for m in mods)
