"""Stage 1: the AST linter (counterpart of
``repro/analysis/lint.py``).

Walks Python sources (default: the port's own files, ``DEFAULT_PATHS``),
parses each module once and runs every rule of
``repro_torch.analysis.rules.ALL_RULES`` over it.  Stdlib only: the lint
stage never imports torch, so it runs in well under a second.

``__pycache__`` / ``.pytest_cache`` / VCS and output directories are
excluded: findings are keyed to checked-in sources only.
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import ALL_RULES

EXCLUDE_DIRS = {"__pycache__", ".pytest_cache", ".git", ".hypothesis",
                "out", ".venv", "node_modules", "runs"}

# what ``run_lint`` reads by default: the port and its own tests, the
# chip script and the example twins (the reference's files are the
# reference's gate, ``python -m repro.analysis``)
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                 "tests/_torch_*.py", "chip_smoke.py", "examples/*_torch.py")

# serve-path modules: every function body in these runs on each serving
# step (RL002 scans them whole; elsewhere only compiled functions are in
# scope).  Prefixes are repo-relative with forward slashes.
SERVE_PATH_PREFIXES = (
    "src/repro_torch/kernels/",
    "src/repro_torch/runtime/dispatch.py",
    "src/repro_torch/runtime/steps.py",
    "src/repro_torch/models/",
)

# where RL004 learns the declared mesh axis names, and which functions
# take them
AXIS_SPEC_MODULE = "src/repro_torch/sharding/rules.py"
COLLECTIVES_MODULE = "src/repro_torch/sharding/collectives.py"


class LintContext:
    """Per-run shared state handed to every rule via ModuleInfo.ctx."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._axes: set[str] | None | bool = False   # False = not computed
        self._collectives: dict | None = None

    def is_serve_path(self, relpath: str) -> bool:
        return relpath.startswith(SERVE_PATH_PREFIXES)

    def declared_axes(self) -> set[str] | None:
        """Mesh axis names the spec layer declares: identifier-like string
        constants inside ``*_axes`` functions of sharding/rules.py, and
        the entries of its ``P(...)`` calls (``_spec_entries``).  None
        when the module is absent (rule RL004 then stays silent)."""
        if self._axes is not False:
            return self._axes
        spec = self.root / AXIS_SPEC_MODULE
        if not spec.is_file():
            self._axes = None
            return None
        tree = ast.parse(spec.read_text())
        axes: set[str] = set()

        def strings(node):
            return {n.value for n in ast.walk(node)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str) and n.value.isidentifier()
                    and len(n.value) <= 16}

        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name.endswith("_axes"):
                for stmt in node.body:
                    if not (isinstance(stmt, ast.Expr)
                            and isinstance(stmt.value, ast.Constant)):
                        axes |= strings(stmt)      # skip the docstring
            elif isinstance(node, ast.Call) and isinstance(node.func,
                                                           ast.Name) \
                    and node.func.id == "P":
                for a in node.args:
                    axes |= _spec_entries(a)
        self._axes = axes
        return axes

    def collectives(self) -> dict[str, tuple[str, int]]:
        """{function: (parameter, position)} for every function of
        sharding/collectives.py that takes mesh axes (a parameter named
        ``axes``) or a partition spec naming them (``spec``); none when
        the module is absent."""
        if self._collectives is not None:
            return self._collectives
        src = self.root / COLLECTIVES_MODULE
        body = ast.parse(src.read_text()).body if src.is_file() else []
        found = {}
        for node in body:
            if isinstance(node, ast.FunctionDef):
                names = [a.arg for a in node.args.posonlyargs
                         + node.args.args]
                for p in ("axes", "spec"):
                    if p in names:
                        found[node.name] = (p, names.index(p))
                        break
        self._collectives = found
        return found


def _spec_entries(node) -> set[str]:
    """The axis names a ``P(...)`` argument can take: string constants as
    the argument itself, in a tuple or list of them, or as either branch
    of a conditional; not strings an expression merely compares
    (``P(None, *_spec2d(..., name != "w_out", ...))``)."""
    if isinstance(node, ast.Constant):
        ok = isinstance(node.value, str) and node.value.isidentifier()
        return {node.value} if ok else set()
    if isinstance(node, (ast.Tuple, ast.List)):
        return set().union(*map(_spec_entries, node.elts))
    if isinstance(node, ast.IfExp):
        return _spec_entries(node.body) | _spec_entries(node.orelse)
    return set()


def iter_source_files(paths: list[Path]) -> list[Path]:
    files = []
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            files.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in EXCLUDE_DIRS for part in f.parts):
                    files.append(f)
    return files


def default_paths(root: Path) -> list[Path]:
    """``DEFAULT_PATHS`` under ``root``, globs expanded, in order."""
    root = Path(root)
    out = []
    for pat in DEFAULT_PATHS:
        out += sorted(root.glob(pat)) if "*" in pat else \
            [root / pat] if (root / pat).exists() else []
    return out


def lint_paths(paths: list[Path], root: Path,
               rules=ALL_RULES) -> list[Finding]:
    """Run ``rules`` over every source under ``paths``; findings carry
    ``root``-relative paths.  A module that fails to parse is itself a
    finding (rule LINT) rather than a crash."""
    ctx = LintContext(root)
    findings: list[Finding] = []
    for f in iter_source_files([Path(p) for p in paths]):
        try:
            rel = f.resolve().relative_to(Path(root).resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            mod = astutil.parse_module(f, rel, ctx)
        except SyntaxError as e:
            findings.append(Finding(rule="LINT", path=rel,
                                    line=e.lineno or 0, scope="",
                                    detail="syntax-error",
                                    message=f"not parseable: {e.msg}"))
            continue
        for rule in rules:
            findings.extend(rule.check(mod))
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings
