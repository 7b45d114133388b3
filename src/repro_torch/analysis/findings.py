"""Findings and the checked-in baseline: the contract gate's currency
(counterpart of ``repro/analysis/findings.py``, the same record and the
same baseline format, so one workflow serves both packages).

A ``Finding`` is one keyed rule violation.  Its ``key`` leaves out the
line number: the baseline must survive unrelated edits that move code
around, so a finding is identified by (rule, file, enclosing scope,
detail) and the line is for display only.

Baseline workflow:
  * ``python -m repro_torch.analysis --update-baseline`` writes every
    current finding's key to the baseline file, one per line; ``#``
    comments (one line of justification above each grandfathered entry)
    are ignored on load.
  * a finding whose key is in the baseline is reported as grandfathered
    and does NOT fail the run; every NEW finding does.
  * baseline entries that match no finding are reported as stale (the
    fix landed: prune the entry) but never fail the run.

Stdlib only, so the lint stage never imports torch.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str        # "RL002".."RL005" (lint) / "TA001".."TA003" (audit)
    path: str        # repo-relative, forward slashes
    line: int        # 1-based; 0 when the finding has no source anchor
    message: str     # human-readable, specific
    detail: str = ""  # stable discriminator for the key (symbol, axis, ...)
    scope: str = ""   # enclosing function/class name ("" = module level)

    @property
    def key(self) -> str:
        """Line-number-free identity used for baseline matching."""
        parts = [self.rule, self.path, self.scope, self.detail]
        return ":".join(p.replace(":", "_") for p in parts)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.rule} {loc} [{self.scope or '<module>'}] {self.message}"


def load_baseline(path: Path) -> set[str]:
    """Baseline keys; a missing file is an empty baseline."""
    if not path.is_file():
        return set()
    keys = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            keys.add(line)
    return keys


def write_baseline(path: Path, findings: list[Finding]) -> None:
    lines = ["# repro_torch.analysis baseline — grandfathered findings, one",
             "# key per line.  Add a '# why' comment above every entry you",
             "# suppress; prune entries the tool reports as stale.", ""]
    lines += sorted({f.key for f in findings})
    path.write_text("\n".join(lines) + "\n")


def split_by_baseline(findings: list[Finding], baseline: set[str]):
    """-> (new, grandfathered, stale_keys)."""
    new = [f for f in findings if f.key not in baseline]
    old = [f for f in findings if f.key in baseline]
    stale = baseline - {f.key for f in findings}
    return new, old, stale
