"""RL002 — host synchronization inside serve-path code.

A ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()``, an ``int()`` /
``float()`` / ``bool()`` of a tensor's value, ``np.asarray`` /
``np.array`` of a tensor, ``torch.cuda.synchronize`` or a
``nonzero`` whose output size depends on the data makes the host wait
for the card.  Inside a serving step that wait happens once per layer
and leaves the card idle while the host catches up (the reference's
counterpart fails at trace time or bakes one call's value into the
compiled program; in an eager package it runs, slowly).

Scope: the serve-path modules (``lint.SERVE_PATH_PREFIXES``: the kernel
wrappers, the dispatch engine, the step factories and the model forward
modules, every function of which runs in a serving step), plus any
function compiled with ``torch.compile`` / ``torch.jit.script``.  The
server loop and the launchers read step OUTPUTS on the host on purpose
(``runtime/server.py``'s one read a tick) and are out of scope.

``int(x.shape[0])``-style calls are exempt: shape, ndim, dtype, device,
``size()``, ``dim()`` and ``numel()`` are metadata the host already
holds.  ``int()`` and friends are checked on parameters annotated as
tensors (``torch.Tensor``); a ``nonzero`` with an explicit ``size=`` is
exempt (its output shape does not depend on the data).
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

RULE_ID = "RL002"
SUMMARY = ("no host-sync calls (.item(), .tolist(), .cpu(), .numpy(), "
           "int()/float()/bool() of a tensor, np.asarray, "
           "torch.cuda.synchronize, nonzero without size=) in serve-path "
           "code")

_HOST_METHODS = ("item", "tolist", "cpu", "numpy")
_HOST_CALLS = ("numpy.asarray", "numpy.array", "torch.cuda.synchronize")
_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "size", "dim",
                 "numel", "element_size", "is_cuda")
_CASTS = ("float", "int", "bool")


def _tensor_params(fn: ast.FunctionDef) -> set[str]:
    """Parameters annotated as tensors (``torch.Tensor``, ``Tensor``)."""
    out = set()
    for p in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        if p.annotation is not None \
                and "Tensor" in ast.unparse(p.annotation):
            out.add(p.arg)
    return out


def _mentions_tensor_without_static_attr(node: ast.AST,
                                         tensors: set[str]) -> bool:
    if any(isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS
           for n in ast.walk(node)):
        return False
    return any(isinstance(n, ast.Name) and n.id in tensors
               for n in ast.walk(node))


def _own_nodes(fn: ast.FunctionDef):
    """Nodes belonging to ``fn`` itself: nested def/class bodies are
    excluded (they are visited as functions in their own right), lambda
    bodies are included (nobody else visits them)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def _is_nonzero(mod, call: ast.Call) -> bool:
    """``torch.nonzero(x)`` / ``x.nonzero()`` without ``size=``."""
    name = mod.canonical(call.func) or ""
    method = isinstance(call.func, ast.Attribute) \
        and call.func.attr == "nonzero"
    if not (name == "torch.nonzero" or method):
        return False
    return not any(kw.arg == "size" for kw in call.keywords)


def check(mod: astutil.ModuleInfo) -> list[Finding]:
    in_scope_module = mod.ctx is not None and mod.ctx.is_serve_path(mod.path)
    findings = []
    for fn, stack in astutil.functions(mod.tree):
        compiled = astutil.jit_decorator(mod, fn) is not None or any(
            isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
            and astutil.jit_decorator(mod, s) is not None for s in stack)
        if not (in_scope_module or compiled):
            continue
        tensors = _tensor_params(fn)
        for call in [n for n in _own_nodes(fn) if isinstance(n, ast.Call)]:
            name = mod.canonical(call.func)

            def add(detail, message):
                findings.append(Finding(
                    rule=RULE_ID, path=mod.path, line=call.lineno,
                    scope=fn.name, detail=detail, message=message))

            if name in _HOST_CALLS:
                add(f"call:{name}",
                    f"{name}() waits for the device: serve-path tensors "
                    "must stay on it (torch.as_tensor on the device for "
                    "constants; no synchronize inside a step)")
            elif _is_nonzero(mod, call):
                add("call:nonzero",
                    "nonzero() without size= sizes its output from the "
                    "data, so the host waits for the device to learn it")
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _HOST_METHODS \
                    and not call.args and not call.keywords:
                add(f"method:{call.func.attr}",
                    f".{call.func.attr}() copies to the host and waits for "
                    "the device: inside a serving step it stalls every "
                    "layer")
            elif (isinstance(call.func, ast.Name)
                  and call.func.id in _CASTS and len(call.args) == 1
                  and _mentions_tensor_without_static_attr(call.args[0],
                                                           tensors)):
                add(f"cast:{call.func.id}:"
                    f"{ast.unparse(call.args[0])[:40]}",
                    f"{call.func.id}() of a tensor's value waits for the "
                    "device (shape/dtype reads are exempt: this argument "
                    "reads the tensor's VALUE)")
    return findings
