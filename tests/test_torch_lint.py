"""The port's repo-contract linter (`repro_torch.analysis.lint`, `python -m
repro_torch lint`) against the reference's (`repro.analysis.lint`).

The port's tree is clean; the reference's synthetic violations give the
same rule ids and nodes in both linters; the port's own import-light
statement flags jax and `repro` anywhere and torch in the planning half
except the five exempt modules; registry completeness is green; the CLI
exits 0 on the port and 1 on a tree with a violation.  Also the one
finding the port's tree had before the linter came: the SSD plain
version's `min()` over `chunk`, written as a plain slice, with its
outputs unchanged on a ragged T.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.analysis import lint as jax_lint

from repro_torch.analysis import lint
from repro_torch.cli import main
from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_scan_plain

from test_torch_support import ROOT, blocked_cli

PORT = ROOT / "src" / "repro_torch"


def test_lint_over_the_port_is_clean():
    assert lint.lint_repo() == []
    assert lint.package_root() == PORT


def test_the_rule_ids_are_the_reference_rule_ids():
    assert set(lint.LINT_RULES) == set(jax_lint.LINT_RULES)
    assert lint._TILE_PARAM_NAMES == jax_lint._TILE_PARAM_NAMES
    assert lint.IMPORT_LIGHT_GLOBS == jax_lint.IMPORT_LIGHT_GLOBS


def _fake_package(root):
    """The reference's synthetic violations (`tests/test_analysis.py`):
    a module-scope jax import in `graph/` beside a guarded one, and a
    silent clamp beside a legal default."""
    pkg = root / "fakepkg"
    (pkg / "graph").mkdir(parents=True)
    (pkg / "kernels" / "thing").mkdir(parents=True)
    (pkg / "graph" / "ir.py").write_text(
        "from typing import TYPE_CHECKING\n"
        "if TYPE_CHECKING:\n    import jax\n"       # guarded: legal
        "import jax.numpy as jnp\n")                # top-level: flagged
    (pkg / "kernels" / "thing" / "ops.py").write_text(
        "def matmul(x, w, bm=None):\n"
        "    bm = min(bm, 128)\n"                   # silent clamp: flagged
        "    return x\n"
        "def legal(x, op, tile=None):\n"
        "    bs = min(512, op.S) if tile is None else tile.get('bs')\n"
        "    return bs\n")
    return pkg


@pytest.mark.parametrize("rule", ["import-light", "no-silent-clamp"])
def test_synthetic_violations_match_the_reference(rule, tmp_path):
    pkg = _fake_package(tmp_path)
    run = {"import-light": (lint.lint_import_light,
                            jax_lint.lint_import_light),
           "no-silent-clamp": (lint.lint_silent_clamp,
                               jax_lint.lint_silent_clamp)}[rule]
    got, want = (fn(pkg) for fn in run)
    assert [(d.rule, d.node) for d in got] == \
        [(d.rule, d.node) for d in want]
    assert [d.rule for d in got] == [f"lint.{rule}"]
    assert got[0].node == {"import-light": "graph/ir.py:4",
                           "no-silent-clamp": "kernels/thing/ops.py:2"}[rule]
    if rule == "no-silent-clamp":
        assert got[0].message == want[0].message
        assert "check_tile" in got[0].hint and "check_launch" in got[0].hint


@pytest.mark.parametrize("source,flagged", [
    ("import repro.graph.ir\n", ["repro"]),
    ("from jaxlib import xla_client\n", ["jaxlib"]),
    ("try:\n    import jax\nexcept ImportError:\n    pass\n", ["jax"]),
    ("import repro_torch.graph\nfrom . import sibling\n", []),
    ("def f():\n    import jax\n", []),
])
def test_jax_and_repro_are_flagged_anywhere(source, flagged, tmp_path):
    """Outside the planning globs too (a kernel module here): the port
    stands alone.  `repro_torch` is not `repro`; function bodies and
    relative imports are not module-scope imports of a root."""
    pkg = tmp_path / "pkg"
    (pkg / "kernels" / "thing").mkdir(parents=True)
    (pkg / "kernels" / "thing" / "ops.py").write_text(source)
    diags = lint.lint_import_light(pkg)
    assert [d.rule for d in diags] == ["lint.import-light"] * len(flagged)
    assert [d.message.split()[1] for d in diags] == flagged


@pytest.mark.parametrize("rel,flagged", [
    ("graph/ir.py", True), ("runtime/plan.py", True),
    ("core/partitioner.py", True), ("cli.py", True),
    ("api.py", False), ("core/coexec.py", False),
    ("runtime/autotune.py", False), ("serving/engine.py", False),
    ("serving/scheduler.py", False),
    ("runtime/executor.py", False), ("models/rwkv.py", False),
])
def test_torch_is_flagged_in_the_planning_half_only(rel, flagged, tmp_path):
    """A module-scope `import torch` in the planning globs is a finding,
    except in the five exempt modules that run on the card; execution
    modules outside the globs may import it."""
    pkg = tmp_path / "pkg"
    path = pkg / rel
    path.parent.mkdir(parents=True)
    path.write_text("import torch\n")
    diags = lint.lint_import_light(pkg)
    assert [(d.rule, d.node) for d in diags] == (
        [("lint.import-light", f"{rel}:1")] if flagged else [])
    if flagged:
        assert "torch" in diags[0].message


def test_the_exempt_modules_are_the_planning_modules_that_import_torch():
    """Each exemption names a module of the planning globs that imports
    torch at module scope today, and no other module of those globs
    does."""
    import ast
    import fnmatch
    importing = set()
    for path in PORT.rglob("*.py"):
        rel = path.relative_to(PORT).as_posix()
        if any(fnmatch.fnmatch(rel, g) for g in lint.IMPORT_LIGHT_GLOBS) \
                and lint.module_imports(ast.parse(path.read_text()),
                                        frozenset({"torch"})):
            importing.add(rel)
    assert importing == set(lint.IMPORT_LIGHT_EXEMPT)
    assert all(lint.IMPORT_LIGHT_EXEMPT.values())


def test_registry_completeness_is_green():
    assert lint.lint_registry(PORT) == []


def test_registry_completeness_flags_a_missing_lowering(tmp_path):
    """The check is textual: a lowering module that never calls
    `register_lowering("<kind>"` is a finding, as in the reference."""
    pkg = tmp_path / "repro_torch"
    shutil.copytree(PORT / "kernels", pkg / "kernels")
    ops = pkg / "kernels" / "ssd_chunk" / "ops.py"
    ops.write_text(ops.read_text().replace('register_lowering("ssm"',
                                           'register_lowering(KIND'))
    diags = lint.lint_registry(pkg)
    assert [(d.rule, d.node) for d in diags] == [
        ("lint.registry-complete", "registry:ssm")]
    assert "never calls register_lowering('ssm')" in diags[0].message


def test_the_ssd_plain_version_clamp_is_flagged_when_present(tmp_path):
    """The finding the linter had in the port's tree: a min() over `chunk`
    in `ssd_chunk_scan_plain`'s chunk range."""
    pkg = tmp_path / "repro_torch"
    shutil.copytree(PORT / "kernels", pkg / "kernels")
    src = pkg / "kernels" / "ssd_chunk" / "ssd_chunk.py"
    text = src.read_text()
    assert "slice(t0, t0 + chunk)" in text and "min(t, t0 + chunk)" not in \
        text
    src.write_text(text.replace("slice(t0, t0 + chunk)",
                                "slice(t0, min(t, t0 + chunk))"))
    diags = lint.lint_silent_clamp(pkg)
    assert [d.rule for d in diags] == ["lint.no-silent-clamp"]
    assert "ssd_chunk_scan_plain() min()-clamps tile param(s) ['chunk']" \
        == diags[0].message
    assert diags[0].node.startswith("kernels/ssd_chunk/ssd_chunk.py:")


@pytest.mark.parametrize("t,chunk", [(100, 64), (37, 16), (5, 64)])
def test_ssd_plain_version_on_a_ragged_t(t, chunk):
    """The chunk range is a plain slice: the ragged last chunk is the
    T % chunk tokens that remain.  One call over T equals, bit for bit,
    the call over the whole chunks followed by a call over the remainder
    from the state the first left."""
    g = torch.Generator().manual_seed(t)
    b, h, hd, n = 2, 3, 8, 16

    def rand(*shape):
        return torch.randn(shape, generator=g)

    x, bm, cm = rand(b, t, h, hd), rand(b, t, n), rand(b, t, n)
    dt = 0.05 + 0.2 * torch.sigmoid(rand(b, t, h))
    a, s0 = -(0.1 + rand(h).abs()), rand(b, h, hd, n)
    sf, y = ssd_chunk_scan_plain(x, bm, cm, dt, a, s0, chunk=chunk)
    assert y.shape == x.shape and sf.shape == s0.shape
    cut = t - t % chunk
    parts, state = [], s0
    for sl in (slice(0, cut), slice(cut, t)):
        if sl.stop > sl.start:
            state, part = ssd_chunk_scan_plain(x[:, sl], bm[:, sl],
                                               cm[:, sl], dt[:, sl], a,
                                               state, chunk=chunk)
            parts.append(part)
    assert torch.equal(y, torch.cat(parts, dim=1))
    assert torch.equal(sf, state)
    assert np.isfinite(y.numpy()).all()


def test_cli_lint_exits_zero_on_the_port(capsys):
    assert main(["lint"]) == 0
    out = capsys.readouterr().out
    assert out.strip() == (
        f"lint {PORT}: 0 finding(s) across [lint.import-light, "
        f"lint.no-silent-clamp, lint.registry-complete]")


@pytest.mark.parametrize("violation", ["import-light", "no-silent-clamp",
                                       "torch"])
def test_cli_lint_exits_one_on_a_violation(violation, tmp_path):
    """`--src` over a copy of the port with one violation added, with jax
    and `repro` kept from import: exit 1, the finding printed under its
    rule id.  The copy sits where the command's imports cannot find
    it."""
    pkg = tmp_path / "tree" / "repro_torch"
    shutil.copytree(PORT, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    if violation == "import-light":
        path, line = pkg / "graph" / "ir.py", "import jax.numpy as jnp\n"
    elif violation == "torch":
        path, line = pkg / "core" / "partitioner.py", "import torch\n"
    else:
        path = pkg / "kernels" / "split_matmul" / "split_matmul.py"
        line = "def clamp(x, bm=None):\n    return min(bm, 128)\n"
    path.write_text(path.read_text() + line)
    out = blocked_cli(["lint", "--src", str(pkg)], tmp_path)
    assert out.returncode == 1, out.stderr
    rule = "import-light" if violation == "torch" else violation
    assert f"lint.{rule}" in out.stdout
    assert f"lint {pkg}: 1 finding(s)" in out.stdout
