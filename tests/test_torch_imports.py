"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
jax nor anything of the JAX package `repro`, not even its jax-free
modules.  Checked twice: by importing every module of the port in a fresh
interpreter, and by scanning the sources' import statements."""
import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_importing_every_port_module_pulls_in_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().splitlines()[-2:]
    assert int(n_modules) > 0
    assert bad == "[]", f"the port imported {bad}"


def test_the_scan_covers_the_verifier_and_the_planner_report():
    mods = _port_modules()
    for m in ("repro_torch.analysis", "repro_torch.analysis.verify",
              "repro_torch.core.planner", "repro_torch.runtime.autotune",
              "repro_torch.kernels.tiles"):
        assert m in mods


#: the planning half's modules (the simulator, the predictors, the
#: partitioner and planner, the plan writer and cache, the model configs
#: and the graph frontends)
PLANNING_MODULES = [
    "repro_torch.core.simulator", "repro_torch.core.simulator.devices",
    "repro_torch.core.simulator.gpu_model",
    "repro_torch.core.simulator.cpu_model",
    "repro_torch.core.simulator.decode_model",
    "repro_torch.core.simulator.measure", "repro_torch.core.sync",
    "repro_torch.core.predictor", "repro_torch.core.predictor.gbdt",
    "repro_torch.core.predictor.features",
    "repro_torch.core.predictor.dataset",
    "repro_torch.core.predictor.train", "repro_torch.core.partitioner",
    "repro_torch.runtime.cache", "repro_torch.models",
    "repro_torch.models.config", "repro_torch.models.registry",
    "repro_torch.configs", "repro_torch.configs.zamba2_7b",
    "repro_torch.graph.frontends",
]


@pytest.mark.parametrize("module", PLANNING_MODULES)
def test_the_scan_covers_the_planning_half(module):
    assert module in _port_modules()


#: the measurement loop's modules (records, the store, the calibrator and
#: the replanner)
MEASURE_MODULES = [
    "repro_torch.measure", "repro_torch.measure.record",
    "repro_torch.measure.store", "repro_torch.measure.calibrate",
    "repro_torch.measure.replan",
]


@pytest.mark.parametrize("module", MEASURE_MODULES)
def test_the_scan_covers_the_measurement_loop(module):
    assert module in _port_modules()
    path = PORT.joinpath(*module.split(".")[1:])
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in sorted(PORT.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_of_the_port_imports_jax_or_repro(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_imports_without_running():
    """Its work sits under `if __name__ == "__main__"`: importing it runs
    nothing (no nvidia-smi, no CUDA) and exposes its phases."""
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main) and callable(mod.main_path)
    assert mod.ARTIFACT.exists()


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Where CUDA is missing (as here) the script exits non-zero and never
    prints the result line — also from a directory holding only it."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
