"""Static and run-time analysis for the port's MCMA serving engine
(counterpart of ``repro/analysis``): the contract gate.

Two stages, one findings vocabulary:

  * **lint** (``repro_torch.analysis.lint``): a stdlib-only AST pass over
    the port's sources enforcing the contracts the AST can see: RL002 no
    host sync in serve-path code, RL004 no undeclared collective axis,
    RL005 grid and page arithmetic that cannot truncate and no kernel
    launch before its argument check (``rules/__init__.py`` says why the
    reference's RL001 and RL003 have no counterpart here);
  * **audit** (``repro_torch.analysis.audit``): runs the real engine
    entry points across capacities x QoS margins x residency sets x row
    masks and checks one step object per capacity rung and no kernel
    rebuild (TA001), int32 stats (TA002) and no host sync inside a step
    (TA003).

CLI: ``python -m repro_torch.analysis`` (see ``__main__``) runs both
stages against ``analysis_baseline_torch.txt`` and fails on any NEW
finding.  ``jit_cache.assert_zero_retrace`` is the test-side helper
(a ``DecodeServer``'s step objects, a ``torch.compile``d callable's
graphs); ``opcount.activation_moves`` counts the standalone activation
gathers and scatters a call runs.
"""
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           split_by_baseline, write_baseline)
from repro_torch.analysis.jit_cache import assert_zero_retrace, cache_size

__all__ = [
    "Finding", "load_baseline", "split_by_baseline", "write_baseline",
    "assert_zero_retrace", "cache_size", "run_lint", "run_audit",
]


def run_lint(paths=None, root="."):
    """Stage 1 over ``paths`` (default: ``lint.DEFAULT_PATHS`` under
    ``root``: the port, its tests, chip_smoke.py and the example twins).
    Stdlib only: safe without torch installed."""
    from pathlib import Path

    from repro_torch.analysis.lint import default_paths, lint_paths
    root = Path(root)
    if paths is None:
        paths = default_paths(root)
    return lint_paths([Path(p) for p in paths], root)


def run_audit(**kw):
    """Stage 2 (imports torch; see ``repro_torch.analysis.audit
    .run_audit``)."""
    from repro_torch.analysis.audit import run_audit as _run
    return _run(**kw)
