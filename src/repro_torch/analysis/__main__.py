"""``python -m repro_torch.analysis``: run the lint + audit gate.

Exit status is the contract: 0 when every finding is either absent or
grandfathered in the baseline file, 1 when any NEW finding appears (or,
with ``--no-baseline``, when any finding at all appears).

    python -m repro_torch.analysis                   # both stages
    python -m repro_torch.analysis --stage lint      # stdlib only
    python -m repro_torch.analysis --stage audit     # CPU, a few seconds
    python -m repro_torch.analysis src/repro_torch/kernels   # a subtree
    python -m repro_torch.analysis --update-baseline # re-grandfather

The baseline (default ``analysis_baseline_torch.txt`` at the repo root)
holds one finding key per line; keys are line-number-free
(``rule:path:scope:detail``) so unrelated edits never churn it.  Stale
baseline entries (fixed findings) are reported but never fail the run;
``--update-baseline`` rewrites the file from the current findings.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

BASELINE = "analysis_baseline_torch.txt"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's MCMA engine contract gate: AST lint + "
                    "run-time audit")
    ap.add_argument("paths", nargs="*", help="files/dirs to lint "
                    "(default: the port, its tests, chip_smoke.py and the "
                    "example twins)")
    ap.add_argument("--stage", choices=("all", "lint", "audit"),
                    default="all")
    ap.add_argument("--root", default=".", help="repo root (baseline + "
                    "finding paths are relative to it)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: ROOT/{BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: any finding fails")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--backends", default="xla,pallas,pallas_fused",
                    help="audit backends (comma-separated)")
    ap.add_argument("--no-steps", action="store_true",
                    help="audit the engine only, skip the model steps")
    args = ap.parse_args(argv)

    from repro_torch.analysis import findings as F

    root = Path(args.root)
    baseline_path = Path(args.baseline) if args.baseline \
        else root / BASELINE
    all_findings = []

    if args.stage in ("all", "lint"):
        from repro_torch.analysis import run_lint
        t0 = time.time()
        lint = run_lint(args.paths or None, root)
        print(f"[lint]  {len(lint)} finding(s) in {time.time() - t0:.2f}s")
        all_findings += lint

    if args.stage in ("all", "audit"):
        from repro_torch.analysis import run_audit
        t0 = time.time()
        audit = run_audit(backends=tuple(args.backends.split(",")),
                          with_steps=not args.no_steps)
        print(f"[audit] {len(audit)} finding(s) in {time.time() - t0:.2f}s")
        all_findings += audit

    if args.update_baseline:
        F.write_baseline(baseline_path, all_findings)
        print(f"baseline: wrote {len(all_findings)} key(s) to "
              f"{baseline_path}")
        return 0

    baseline = set() if args.no_baseline else F.load_baseline(baseline_path)
    new, old, stale = F.split_by_baseline(all_findings, baseline)
    for f in new:
        print(f.render())
    if old:
        print(f"[baseline] {len(old)} grandfathered finding(s) suppressed")
    for key in sorted(stale):
        print(f"[stale] baseline entry no longer found: {key} "
              "(run --update-baseline)")
    if new:
        print(f"FAILED: {len(new)} new finding(s); fix them or (last "
              f"resort) grandfather via --update-baseline")
        return 1
    print("OK: no new findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
