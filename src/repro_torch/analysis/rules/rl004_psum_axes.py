"""RL004 — collective axis names must be declared in sharding/rules.py.

Every mesh the port builds takes its axis names from the spec layer
(``sharding/rules.py``: the ``("pod", "data")`` data meta-axis,
``"model"``).  A collective of ``sharding/collectives.py`` over a name no
spec declares fails only at RUN time, on a mesh, inside a rank (the
worst place), or, with a misspelt data-axis name, skips the reduction
the invoke stats' exactness depends on (the all-reduced ``counts`` must
equal the single device's; runtime/dispatch.py ``stats_axes``).

The checked calls are those of every function of sharding/collectives.py
that takes mesh axes (a parameter named ``axes``: ``all_gather``,
``all_reduce_sum``, ``all_reduce_sum_many``, ...) or a partition spec
naming them (``spec``: ``gather_whole``, ``spec_axes``, ...), read from
that module.  Literal axis names (a string, a tuple of strings, a
``P(...)`` spec, or a name bound once to one of these in the calling
function) are checked against the declared set; names that reach the
call through parameters (``stats_axes``-style plumbing) are accepted:
that plumbing is how the engine stays mesh-agnostic.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

RULE_ID = "RL004"
SUMMARY = ("axis names passed to sharding/collectives.py must be declared "
           "in sharding/rules.py specs")

_MODULE = "repro_torch.sharding.collectives"


def _spec_strings(node: ast.AST):
    """Literal axis names of an ``axes``/``spec`` argument; None = not
    statically resolvable.  Accepts a string, None, a tuple/list of
    these (nested), and a ``P(...)`` call over them."""
    if isinstance(node, ast.Constant) and (node.value is None
                                           or isinstance(node.value, str)):
        return [] if node.value is None else [node.value]
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "P" and not node.keywords:
        elts = node.args
    elif isinstance(node, (ast.Tuple, ast.List)):
        elts = node.elts
    else:
        return None
    out = []
    for el in elts:
        sub = _spec_strings(el)
        if sub is None:
            return None
        out += sub
    return out


def _resolve_axes(node: ast.AST, fn: ast.FunctionDef | None):
    """Literal axis names of the argument, chasing one level of local
    assignment; None = not statically resolvable (accepted)."""
    items = _spec_strings(node)
    if items is not None:
        return items
    if isinstance(node, ast.Name) and fn is not None:
        resolved, count = None, 0
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and n.targets[0].id == node.id:
                count += 1
                resolved = _spec_strings(n.value)
        if count == 1:
            return resolved
    return None


def _axis_arg(call: ast.Call, param: str, index: int) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    return call.args[index] if len(call.args) > index else None


def check(mod: astutil.ModuleInfo) -> list[Finding]:
    ctx = mod.ctx
    declared = ctx.declared_axes() if ctx is not None else None
    if not declared:
        return []           # no spec layer to check against
    collectives = ctx.collectives()
    inside = mod.path.endswith("sharding/collectives.py")
    findings = []
    fns = astutil.functions(mod.tree)

    def enclosing_fn(call):
        best = None
        for fn, _ in fns:
            if fn.lineno <= call.lineno <= max(
                    getattr(fn, "end_lineno", fn.lineno), fn.lineno):
                best = fn
        return best

    for call in [n for n in astutil.nodes(mod.tree)
                 if isinstance(n, ast.Call)]:
        name = mod.canonical(call.func) or ""
        short = name.split(".")[-1]
        if short not in collectives or not (
                name == f"{_MODULE}.{short}"
                or (inside and isinstance(call.func, ast.Name))):
            continue
        axis_node = _axis_arg(call, *collectives[short])
        if axis_node is None:
            continue
        fn = enclosing_fn(call)
        axes = _resolve_axes(axis_node, fn)
        if axes is None:
            continue        # parameter-plumbed axes: mesh-agnostic by design
        for ax in axes:
            if ax not in declared:
                findings.append(Finding(
                    rule=RULE_ID, path=mod.path, line=call.lineno,
                    scope=fn.name if fn else "", detail=f"axis:{ax}",
                    message=(f"{short}() over axis {ax!r} which no "
                             "sharding/rules.py spec declares (known: "
                             f"{sorted(declared)}): the mesh has no such "
                             "axis, so this fails on a rank at run time, "
                             "or a misspelt data axis skips the stats "
                             "reduction")))
    return findings
