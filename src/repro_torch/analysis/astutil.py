"""Shared AST plumbing for the lint rules (counterpart of
``repro/analysis/astutil.py``; stdlib only).

Every rule works on a ``ModuleInfo``: the parsed tree plus an import
alias map, so calls are matched on their CANONICAL dotted name
(``repro_torch.sharding.collectives.all_reduce_sum`` whether the module
wrote ``C.all_reduce_sum`` after ``from repro_torch.sharding import
collectives as C`` or imported the function itself).
"""
from __future__ import annotations

import ast
import collections
import dataclasses
from pathlib import Path

# the compile decorators of the port (an eager package: none is used on
# its serve path today, so every function there is checked as written)
COMPILE_DECORATORS = ("torch.compile", "torch.jit.script")


@dataclasses.dataclass
class ModuleInfo:
    path: str                  # repo-relative, forward slashes
    tree: ast.Module
    aliases: dict[str, str]    # local name -> canonical dotted prefix
    ctx: "object" = None       # LintContext (lint.py); rules may use it

    def canonical(self, node: ast.AST) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, alias-expanded
        (``C.all_gather`` -> ``repro_torch.sharding.collectives
        .all_gather``); None when the expression is not a plain dotted
        chain."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        parts[0] = self.aliases.get(parts[0], parts[0])
        return ".".join(parts)


def _index(tree: ast.AST) -> None:
    """One traversal of ``tree`` recording every node (``nodes``) and every
    function with its enclosing stack (``functions``) on the tree itself:
    the rules each scan a module, and walking it anew for each was most
    of the lint stage's time."""
    all_nodes, fns = [], []
    todo = collections.deque([(tree, ())])
    while todo:                          # breadth first, as ast.walk
        node, stack = todo.popleft()
        all_nodes.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.append((node, stack))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            stack = stack + (node,)
        todo.extend((c, stack) for c in ast.iter_child_nodes(node))
    # a def's source position is its depth-first place: outermost first,
    # each function's nested ones right after it
    fns.sort(key=lambda f: (f[0].lineno, f[0].col_offset))
    tree._all_nodes, tree._functions = all_nodes, fns


def nodes(tree: ast.AST) -> list:
    """Every node of ``tree``, computed once per tree."""
    if not hasattr(tree, "_all_nodes"):
        _index(tree)
    return tree._all_nodes


def collect_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def parse_module(path: Path, rel: str, ctx=None) -> ModuleInfo:
    tree = ast.parse(path.read_text(), filename=str(path))
    return ModuleInfo(path=rel, tree=tree, aliases=collect_aliases(tree),
                      ctx=ctx)


def functions(tree: ast.AST):
    """Every (func_node, enclosing_stack) in the tree, outermost first.
    The stack holds the chain of enclosing FunctionDef/AsyncFunctionDef/
    ClassDef nodes (closest last).  Computed once per tree."""
    if not hasattr(tree, "_functions"):
        _index(tree)
    return tree._functions


def param_names(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def assigned_names(fn: ast.FunctionDef) -> set[str]:
    """Names bound anywhere inside ``fn`` (assignments, for targets,
    with-as, comprehension targets, nested defs/lambda params excluded)."""
    bound: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        bound.add(n.id)
        elif isinstance(node, (ast.For, ast.comprehension)):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    bound.add(n.id)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            for n in ast.walk(node.optional_vars):
                if isinstance(n, ast.Name):
                    bound.add(n.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
    return bound


def jit_decorator(mod: ModuleInfo, fn: ast.FunctionDef):
    """The compile decoration of ``fn``, if any: ``@torch.compile``,
    ``@torch.compile(...)``, ``@torch.jit.script`` or
    ``@functools.partial(torch.compile, ...)``.  Returns the decorator
    node, else None (the port's code is eager: None everywhere today)."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = mod.canonical(target)
        if name in COMPILE_DECORATORS:
            return dec
        if isinstance(dec, ast.Call) and name in ("functools.partial",
                                                  "partial"):
            if dec.args and mod.canonical(dec.args[0]) in COMPILE_DECORATORS:
                return dec
    return None


def string_items(node: ast.AST) -> list[str] | None:
    """Resolve a string literal or tuple/list of string literals; None
    when any element is not a plain constant string."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append(el.value)
            else:
                return None
        return out
    return None


def dump(node: ast.AST) -> str:
    """Location-free structural fingerprint for comparing sub-expressions
    (``t`` in ``t // b`` vs ``t`` in ``assert t % b == 0``)."""
    return ast.dump(node, annotate_fields=False)
