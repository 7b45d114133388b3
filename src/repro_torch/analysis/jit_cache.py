"""Zero-retrace assertions (counterpart of
``repro/analysis/jit_cache.py``): the shared helper behind the engine's
one-program-per-capacity contract.

The serving architecture's invariant: traced inputs (QoS margins,
residency vectors, tier mixes, row masks) flow through ONE program; only
shapes (capacities, batch) may make a new one.  The reference counts a
``jax.jit`` cache.  The port runs eagerly, and its "compiled program" is
a STEP OBJECT: a ``DecodeServer`` builds one decode step (and one chunk
step) for each capacity rung it serves, and a new tier mix, residency or
mask must go through the same objects.  ``cache_size`` therefore counts

  * for a ``DecodeServer``: the step objects it built to serve, by kind
    (``step_objects``; the larger count of decode and chunk steps), which
    under autotune must equal the rungs it visited and otherwise 1;
  * for a ``torch.compile``d callable: its compiled graphs;
  * for a plain eager callable: nothing to count (None), as the
    reference's for a jax without ``_cache_size``.

``kernel_builds`` counts the other thing an eager call could recompile:
the CUDA libraries (``kernels/build.py``), at most one per source, with
no ``nvcc`` after the first call.

    from repro_torch.analysis.jit_cache import assert_zero_retrace
    srv.run_until_drained()
    assert_zero_retrace(srv, "a live residency swap")
"""
from __future__ import annotations

import inspect


def _is_server(obj) -> bool:
    return hasattr(obj, "step_builds") and hasattr(obj, "controller")


def step_objects(server) -> dict[str, int]:
    """The step objects a ``DecodeServer`` built to serve, by kind:
    ``{"decode": n, "chunk": m}``.  Under autotune those are the rung
    steps (its static step at no operating point is never run); without,
    every step it built."""
    autotuned = server.controller is not None
    out = {"decode": 0, "chunk": 0}
    for kind, point in server.step_builds:
        if point is not None or not autotuned:
            out[kind] += 1
    return out


def cache_size(fn) -> int | None:
    """Programs behind ``fn``: a ``DecodeServer``'s step objects (the
    larger of its decode and chunk counts), a ``torch.compile``d
    callable's compiled graphs, or None when there is nothing to count
    (an eager callable)."""
    if _is_server(fn):
        return max(step_objects(fn).values())
    orig = getattr(fn, "_torchdynamo_orig_callable", None)
    if orig is None:
        return None
    from torch._dynamo import eval_frame
    target = inspect.unwrap(getattr(orig, "forward", orig))
    code = getattr(target, "__code__", None)
    if code is None:
        return None
    return len(eval_frame._debug_get_cache_entry_list(code))


def kernel_builds() -> dict:
    """``{"loaded": {source: libraries}, "compiles": nvcc runs so far}``:
    every CUDA library loaded in this process (at most one per source of
    ``kernels/build.SOURCES``) and the ``nvcc`` processes started."""
    from repro_torch.kernels import build
    return {"loaded": {name: 1 for name in build._loaded},
            "compiles": build.build_all.compiles}


def assert_zero_retrace(fn, what: str = "a traced-input change", *,
                        expected: int = 1) -> None:
    """Assert ``fn`` holds exactly ``expected`` program(s).

    ``what`` names the input that must not make a new one; it leads the
    failure message ("<what> forced a retrace: ...").  Silent when there
    is nothing to count."""
    n = cache_size(fn)
    if n is None:        # an eager callable: nothing to count
        return
    assert n == expected, (
        f"{what} forced a retrace: {n} compiled programs where {expected} "
        f"expected — traced inputs must reuse the same step objects "
        f"(only shapes and capacity rungs may build a new one)")
