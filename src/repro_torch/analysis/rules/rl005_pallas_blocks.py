"""RL005 — kernel grid and page arithmetic must prove divisibility, and a
kernel launches only after its argument check.

The module keeps the reference's name (``rl005_pallas_blocks``) for name
parity; in the port it covers the CUDA launchers and their wrappers.

(a) Grid arithmetic.  Under ``kernels/`` every floor division must use
the round-up idiom ``(x + b - 1) // b`` or the port's ``-(-x // b)``,
or sit behind a divisibility assert (``assert t % block_t == 0``) in the
same function.  A bare ``t // block_t`` silently TRUNCATES when t stops
dividing: rows past the last whole tile never reach a kernel and come
back as zeros (this is how a block_t change would corrupt the
class-sort plan: ops.class_sort_plan pads to ``worst_case_rows`` and the
tile count must stay exact).  Page arithmetic is covered EVERYWHERE: a
floor division whose denominator mentions ``page`` (the paged KV cache's
block tables in models/, the server's allocator) is held to the same
contract in any module.  A quotient taken beside the remainder of the
same operands in one function (a position split into page and offset,
the port's spelling of the reference's ``jnp.divmod``) truncates nothing
and is accepted.

(b) Launch guard.  In place of the reference's BlockSpec arity check:
a kernel is launched through a library handle from
``kernels/build.load(...)``, and every such call must follow, in the
same function, a call of the wrapper's argument check
(``switched_mlp.check_cuda_args``, ``slstm_scan._check_cuda_args``):
the guard that refuses a shape, dtype or layout the tile routine cannot
take (kernels/switched_mlp.py ``check_cuda_args``) before the kernel
reads past a buffer.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

RULE_ID = "RL005"
SUMMARY = ("kernel grid / page floor divisions need the round-up idiom, "
           "-(-x // b), or a same-function divisibility assert; a kernel "
           "launch through build.load needs the argument check first")

_CHECK_SUFFIX = "check_cuda_args"


def _grid_scope(mod: astutil.ModuleInfo) -> bool:
    """The kernel wrappers: everything under ``kernels/``."""
    return "kernels/" in mod.path


def _divisibility_asserts(fn: ast.FunctionDef) -> set[tuple[str, str]]:
    """{(dump(numerator), dump(denominator))} proven by asserts of the
    form ``assert a % b == 0`` (also found inside and/or chains)."""
    proven = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assert):
            continue
        tests = [node.test]
        while tests:
            t = tests.pop()
            if isinstance(t, ast.BoolOp):
                tests.extend(t.values)
                continue
            if isinstance(t, ast.Compare) and len(t.ops) == 1 \
                    and isinstance(t.ops[0], ast.Eq) \
                    and isinstance(t.left, ast.BinOp) \
                    and isinstance(t.left.op, ast.Mod) \
                    and isinstance(t.comparators[0], ast.Constant) \
                    and t.comparators[0].value == 0:
                proven.add((astutil.dump(t.left.left),
                            astutil.dump(t.left.right)))
    return proven


def _remainders(fn: ast.FunctionDef) -> set[tuple[str, str]]:
    """{(dump(a), dump(b))} of every ``a % b`` outside an assert: with a
    ``a // b`` beside it, the pair is a divmod."""
    asserted = {id(n) for a in ast.walk(fn) if isinstance(a, ast.Assert)
                for n in ast.walk(a)}
    return {(astutil.dump(n.left), astutil.dump(n.right))
            for n in ast.walk(fn) if isinstance(n, ast.BinOp)
            and isinstance(n.op, ast.Mod) and id(n) not in asserted}


def _is_roundup_idiom(num: ast.AST, den: ast.AST) -> bool:
    """(x + b - 1) // b: the numerator mentions the denominator and adds
    or subtracts a 1 beside it."""
    nd, dd = astutil.dump(num), astutil.dump(den)
    if dd not in nd:
        return False
    return any(isinstance(n, ast.Constant) and n.value == 1
               for n in ast.walk(num))


def _negated_ceil_divs(fn: ast.FunctionDef) -> set[int]:
    """ids of the ``-x // b`` nodes of ``-(-x // b)`` round-ups."""
    out = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub) \
                and isinstance(n.operand, ast.BinOp) \
                and isinstance(n.operand.op, ast.FloorDiv) \
                and isinstance(n.operand.left, ast.UnaryOp) \
                and isinstance(n.operand.left.op, ast.USub):
            out.add(id(n.operand))
    return out


def _library_handles(mod, fn: ast.FunctionDef) -> set[str]:
    """Names bound in ``fn`` to ``...build.load(...)``."""
    out = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and isinstance(n.value, ast.Call) \
                and (mod.canonical(n.value.func) or "").endswith("build.load"):
            out.add(n.targets[0].id)
    return out


def _launch_handle(call: ast.Call, handles: set[str]) -> str | None:
    """The handle a call launches through: ``lib.fn(...)`` or
    ``getattr(lib, name)(...)``."""
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in handles:
        return f.value.id
    if isinstance(f, ast.Call) and isinstance(f.func, ast.Name) \
            and f.func.id == "getattr" and f.args \
            and isinstance(f.args[0], ast.Name) and f.args[0].id in handles:
        return f.args[0].id
    return None


def _check_launches(mod, fn, findings):
    handles = _library_handles(mod, fn)
    if not handles:
        return
    checks = [n.lineno for n in ast.walk(fn) if isinstance(n, ast.Call)
              and (mod.canonical(n.func) or "").endswith(_CHECK_SUFFIX)]
    for call in [n for n in ast.walk(fn) if isinstance(n, ast.Call)]:
        handle = _launch_handle(call, handles)
        if handle is None or any(line < call.lineno for line in checks):
            continue
        findings.append(Finding(
            rule=RULE_ID, path=mod.path, line=call.lineno, scope=fn.name,
            detail=f"unchecked-launch:{handle}",
            message=(f"a kernel launches through `{handle}` (from "
                     "build.load) with no argument check before it in this "
                     "function: call the wrapper's check_cuda_args first, "
                     "or a shape the tile routine refuses reaches the "
                     "kernel")))


def check(mod: astutil.ModuleInfo) -> list[Finding]:
    grid_scope = _grid_scope(mod)
    findings = []

    def bound(n):
        # outside kernels/ only page-grid divisions are bound by the
        # contract
        return isinstance(n, ast.BinOp) and isinstance(n.op, ast.FloorDiv) \
            and (grid_scope or "page" in astutil.dump(n.right).lower())

    def loads(n):
        return isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
            and n.func.attr == "load"

    everything = astutil.nodes(mod.tree)
    any_div = any(map(bound, everything))
    any_load = any(map(loads, everything))
    if not (any_div or any_load):
        return findings
    for fn, _ in astutil.functions(mod.tree):
        nodes = list(ast.walk(fn))
        divs = [n for n in nodes if bound(n)] if any_div else []
        if divs:
            proven = _divisibility_asserts(fn) | _remainders(fn)
            ceil_divs = _negated_ceil_divs(fn)
        for node in divs:
            num, den = node.left, node.right
            if (astutil.dump(num), astutil.dump(den)) in proven \
                    or id(node) in ceil_divs \
                    or _is_roundup_idiom(num, den):
                continue
            findings.append(Finding(
                rule=RULE_ID, path=mod.path, line=node.lineno,
                scope=fn.name,
                detail=f"floordiv:{ast.unparse(node)[:48]}",
                message=(f"`{ast.unparse(node)}` floor-divides with no "
                         "round-up idiom / divisibility assert in this "
                         "function: a non-dividing size silently truncates "
                         "the grid (rows past the last tile never "
                         "launch)")))
        if any_load and any(map(loads, nodes)):
            _check_launches(mod, fn, findings)
    return findings
