"""Repo-contract linter of the port: machine-check the conventions the
port relies on, under the reference's rule ids (`repro.analysis.lint`).

  * ``lint.import-light`` — the port's own statement of the rule.  Two
    parts, each over module-scope imports only (function bodies are not
    module scope; ``if TYPE_CHECKING:`` blocks are exempt; ``try``,
    ``with`` and class bodies are walked, as the reference walks them):
      - no module of the port imports ``jax``, ``jaxlib`` or the JAX
        package ``repro``.  The port stands alone: it keeps its own copies
        of what it needs, even of the reference's jax-free modules
        (`tests/test_torch_imports.py` checks the same by importing every
        module);
      - the planning half does not import ``torch``.  The planning half is
        the reference's import-light globs (`IMPORT_LIGHT_GLOBS`): the
        planner, simulator, predictors, graph IR, plan writer and cache,
        measurement loop, serving control plane and this package.
        Planning runs on a serving host's control plane and in containers
        without a card, and a stray module-scope ``import torch`` there
        loads the CUDA runtime into every `plan`.  `IMPORT_LIGHT_EXEMPT`
        names the five modules of those globs that run on the card, each
        with its reason.
    The rule checks each file's own statements.  It does not claim that
    `python -m repro_torch lint` runs without torch: the package's
    `__init__.py` imports `api.py`, and that module imports torch.
  * ``lint.registry-complete`` — every registered op kind carries the
    full contract surface: shape/feature callables, a codec entry, a tile
    spec, a registered lowering module, and either channel splittability
    or declared typed axes.  A half-registered kind compiles plans the
    executor cannot lower.
  * ``lint.no-silent-clamp`` — kernel entry points must not
    ``min()``-clamp user-provided tile parameters.  An illegal launch is a
    caller bug; silently shrinking it makes autotune measurements lie
    about the launch they claim to measure.  Validation lives in
    `kernels/tiles.py` (`check_tile`, `check_chunk`, `check_launch`),
    which raises.

Stdlib plus the port's registry tables (`kernels/registry.py`, whose
own statements import no torch).
"""
from __future__ import annotations

import ast
import fnmatch
from pathlib import Path
from typing import FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis.verify import SEV_ERROR, Diagnostic

LINT_RULES = {
    "lint.import-light": "no top-level jax/jaxlib/repro imports in any "
                         "module; no top-level torch imports in planning/"
                         "graph/measure/serving modules",
    "lint.registry-complete": "every op kind has codec + features + "
                              "tiles + lowering + axes-or-splittable",
    "lint.no-silent-clamp": "kernel entry points never min()-clamp "
                            "user tile params",
}

#: roots no module of the port may import at module scope
FORBIDDEN_ROOTS = frozenset({"jax", "jaxlib", "repro"})

#: modules (relative to the repro_torch package) whose module scope may
#: not import torch: the reference's import-light globs, path for path
IMPORT_LIGHT_GLOBS = (
    "__init__.py", "__main__.py", "api.py", "cli.py",
    "graph/*.py", "measure/*.py", "serving/*.py", "analysis/*.py",
    "core/*.py", "core/predictor/*.py", "core/simulator/*.py",
    "runtime/__init__.py", "runtime/plan.py", "runtime/cache.py",
    "runtime/autotune.py",
    "kernels/__init__.py", "kernels/registry.py", "kernels/tiles.py",
)

#: the modules of those globs that run on the card, and why each imports
#: torch at module scope
IMPORT_LIGHT_EXEMPT = {
    # CompiledNetwork.run/executor/record and the dtype table of its
    # executions: the public facade runs plans, not only compiles them
    "api.py": "the facade executes plans on torch devices",
    # the reference exempts it too: it owns the two groups' devices and
    # streams that co-execution synchronizes
    "core/coexec.py": "the execution sync layer (devices, streams, events)",
    # the tuner times candidate launches with CUDA events on the card
    "runtime/autotune.py": "times launches on the card (CUDA events)",
    # batches requests into tensors and samples tokens on the device
    "serving/engine.py": "runs the model's prefill and decode on the card",
    # the continuous scheduler's slot caches and per-slot positions
    "serving/scheduler.py": "runs the model's decode steps on the card",
}

#: parameter names that carry user tile choices into kernel entry points
_TILE_PARAM_NAMES = {"tile", "tiles", "bm", "bn", "bk", "bs", "chunk"}


def _err(rule: str, node: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(SEV_ERROR, rule, node, message, hint)


def package_root() -> Path:
    """The repro_torch package directory the default lint run scans."""
    return Path(__file__).resolve().parents[1]


# --------------------------------------------------------- import-light

def _is_type_checking(test: ast.expr) -> bool:
    return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or \
        (isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING")


def module_imports(tree: ast.Module,
                   roots: FrozenSet[str]) -> List[Tuple[int, str]]:
    """(line, root) of each module-scope import of a package in `roots`
    (TYPE_CHECKING-guarded blocks excluded; function bodies are not module
    scope; relative imports name no root)."""
    found: List[Tuple[int, str]] = []

    def visit(stmts, guarded: bool) -> None:
        for s in stmts:
            if isinstance(s, ast.Import):
                names = [a.name for a in s.names]
            elif isinstance(s, ast.ImportFrom):
                names = [s.module] if s.module and not s.level else []
            elif isinstance(s, ast.If):
                visit(s.body, guarded or _is_type_checking(s.test))
                visit(s.orelse, guarded)
                continue
            elif isinstance(s, ast.Try):
                for blk in [s.body, s.orelse, s.finalbody,
                            *[h.body for h in s.handlers]]:
                    visit(blk, guarded)
                continue
            elif isinstance(s, (ast.With, ast.ClassDef)):
                visit(s.body, guarded)
                continue
            else:
                continue
            if guarded:
                continue
            for root in sorted({n.split(".")[0] for n in names} & roots):
                found.append((s.lineno, root))

    visit(tree.body, False)
    return found


def lint_import_light(pkg: Path) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    hint = ("move the import inside the functions that use it (or under "
            "`if TYPE_CHECKING:` for annotations)")
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(pkg).as_posix()
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError as e:
            diags.append(_err("lint.import-light", f"{rel}:{e.lineno}",
                              f"does not parse: {e.msg}"))
            continue
        light = (rel not in IMPORT_LIGHT_EXEMPT and
                 any(fnmatch.fnmatch(rel, g) for g in IMPORT_LIGHT_GLOBS))
        roots = FORBIDDEN_ROOTS | ({"torch"} if light else set())
        for lineno, root in module_imports(tree, roots):
            if root == "torch":
                message = "top-level torch import in an import-light module"
                fix = hint
            else:
                message = (f"top-level {root} import: the port imports "
                           f"neither jax nor the JAX package")
                fix = "keep the port's own copy of what it needs"
            diags.append(_err("lint.import-light", f"{rel}:{lineno}",
                              message, fix))
    return diags


# -------------------------------------------------- registry completeness

def lint_registry(pkg: Path) -> List[Diagnostic]:
    from repro_torch.kernels import registry
    diags: List[Diagnostic] = []
    kinds = registry.kinds()
    codec_kinds = set(registry._KIND_BY_TYPE.values())
    if codec_kinds != set(kinds):
        diags.append(_err(
            "lint.registry-complete", "registry",
            f"op codec covers {sorted(codec_kinds)} but the registry "
            f"declares {kinds}"))
    for kind in kinds:
        entry = registry.get(kind)
        loc = f"registry:{kind}"
        for field in ("input_shape", "weight_shape", "output_shape",
                      "base_features"):
            if not callable(getattr(entry, field, None)):
                diags.append(_err("lint.registry-complete", loc,
                                  f"kind lacks a callable {field!r}"))
        if not entry.splittable and not entry.axes:
            diags.append(_err(
                "lint.registry-complete", loc,
                "kind is neither channel-splittable nor declares typed "
                "axes — the planner can never co-execute or even place "
                "it deliberately",
                "declare AxisSpecs or set splittable=True"))
        try:
            registry.tile_spec(kind)
        except KeyError:
            diags.append(_err("lint.registry-complete", loc,
                              "kind has no TileSpec",
                              "register it in _TILE_SPECS"))
        if entry.modes and registry.default_mode(kind) != entry.modes[0]:
            diags.append(_err("lint.registry-complete", loc,
                              "default_mode disagrees with the entry's "
                              "declared mode order"))
        mod = registry._LOWERING_MODULES.get(kind)
        if mod is None:
            diags.append(_err("lint.registry-complete", loc,
                              "kind has no lowering module mapping",
                              "add it to _LOWERING_MODULES"))
            continue
        # the ops module imports torch and builds nothing until called,
        # but the check stays textual, as the reference's
        ops_path = pkg / Path(*mod.split(".")[1:]).with_suffix(".py")
        if not ops_path.is_file():
            diags.append(_err("lint.registry-complete", loc,
                              f"lowering module {mod} has no source file"))
        elif f'register_lowering("{kind}"' not in ops_path.read_text():
            diags.append(_err(
                "lint.registry-complete", loc,
                f"lowering module {mod} never calls "
                f"register_lowering({kind!r})"))
    return diags


# --------------------------------------------------------- no-silent-clamp

def lint_silent_clamp(pkg: Path) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for path in sorted((pkg / "kernels").rglob("*.py")):
        if path.name in ("registry.py", "tiles.py", "__init__.py"):
            continue
        rel = path.relative_to(pkg).as_posix()
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:
            continue                       # import-light pass reports these
        for fn in [n for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]:
            args = fn.args
            params: Set[str] = {a.arg for a in
                                [*args.posonlyargs, *args.args,
                                 *args.kwonlyargs]} & _TILE_PARAM_NAMES
            if not params:
                continue
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)
                        and call.func.id == "min"):
                    continue
                touched = {n.id for a in call.args
                           for n in ast.walk(a)
                           if isinstance(n, ast.Name)} & params
                if touched:
                    diags.append(_err(
                        "lint.no-silent-clamp",
                        f"{rel}:{call.lineno}",
                        f"{fn.name}() min()-clamps tile param(s) "
                        f"{sorted(touched)}",
                        "validate via kernels/tiles.py check_tile, "
                        "check_chunk or check_launch (raise on illegal) "
                        "instead of silently shrinking"))
    return diags


# ------------------------------------------------------------ all rules

def lint_repo(pkg: Optional[Path] = None) -> List[Diagnostic]:
    """Run every repo-contract lint over the repro_torch package tree."""
    pkg = package_root() if pkg is None else Path(pkg)
    diags: List[Diagnostic] = []
    diags.extend(lint_import_light(pkg))
    diags.extend(lint_registry(pkg))
    diags.extend(lint_silent_clamp(pkg))
    return diags
