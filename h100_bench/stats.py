"""End-to-end statistics over one run's record, on the host clock.

Times are seconds on one clock; the window is [w0, w1).  Every request
counts: a request due in the window with no token by its end enters the
time-to-first-token tail at the time it has waited, so a stall cannot
hide, and the rate is every token of the window over the window's whole
length.
"""
from __future__ import annotations

import numpy as np


def p95(values) -> float | None:
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, 95)) if v.size else None


def output_tokens_per_s(token_times: list, w0: float, w1: float) -> float:
    """Every output token stamped in the window, over its length."""
    n = sum(int(np.count_nonzero((np.asarray(t) >= w0)
                                 & (np.asarray(t) < w1)))
            for t in token_times)
    return n / (w1 - w0)


def ttft_values(due: list, first: list, w0: float, w1: float) -> list:
    """Seconds from the due time to the first token of every request due
    in the window; a request with none by w1 counts w1 - due."""
    out = []
    for d, f in zip(due, first):
        if not w0 <= d < w1:
            continue
        out.append((f if f is not None and f < w1 else w1) - d)
    return out


def itl_values(token_times: list, w0: float, w1: float) -> list:
    """Every gap between consecutive tokens of a request that ends in the
    window."""
    out = []
    for t in token_times:
        t = np.asarray(t, np.float64)
        if t.size < 2:
            continue
        gaps = np.diff(t)
        end = t[1:]
        out.extend(gaps[(end >= w0) & (end < w1)].tolist())
    return out
