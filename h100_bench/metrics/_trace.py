"""Shared reading of the traced stretch (``harness.read_trace``): device
operations by tick span, their busy union, and the breakdown."""
from __future__ import annotations

import numpy as np


def window(tr: dict) -> tuple[int, int]:
    """The traced stretch in the profiler's ns: first tick's start to the
    last tick's end."""
    return int(tr["spans"][0, 0]), int(tr["spans"][-1, 1])


def _merged(tr: dict):
    """Device operation intervals inside the window, merged: (starts,
    ends)."""
    a, b = window(tr)
    s = np.clip(tr["start"], a, b)
    e = np.clip(tr["start"] + tr["dur"], a, b)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s)
    s, e = s[order], e[order]
    if not len(s):
        return s, e
    run_end = np.maximum.accumulate(e)
    new = np.r_[True, s[1:] > run_end[:-1]]
    idx = np.flatnonzero(new)
    ends = np.maximum.reduceat(e, idx)
    return s[idx], ends


def busy(tr: dict) -> tuple[float, float]:
    """(seconds some device operation ran, seconds of the stretch)."""
    a, b = window(tr)
    s, e = _merged(tr)
    return float((e - s).sum()) / 1e9, (b - a) / 1e9


def in_phase(tr: dict, phase: str):
    """(operations' tick index or -1, mask of operations whose start lies
    in a tick of ``phase``)."""
    spans = tr["spans"]
    k = np.searchsorted(spans[:, 0], tr["start"], side="right") - 1
    ok = (k >= 0) & (tr["start"] < spans[np.clip(k, 0, None), 1])
    ph = np.array([p == phase for p in tr["phases"]])
    return k, ok & ph[np.clip(k, 0, None)]


def n_ticks(tr: dict, phase: str) -> int:
    return sum(1 for p in tr["phases"] if p == phase)


def breakdown(tr: dict) -> dict:
    """The ten device operations that took most time, and the idle time
    by what the host was doing: the phase of the tick it fell in (or the
    harness between ticks) and the operation that ended it."""
    names = np.asarray(tr["names"], dtype=object)
    tot = {}
    for n, d in zip(names, tr["dur"]):
        tot[n] = tot.get(n, 0) + int(d)
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    short = lambda n: n[:160]             # templated kernel names run long
    s, e = _merged(tr)
    a, b = window(tr)
    gap_s = np.r_[a, e]
    gap_e = np.r_[s, b]
    spans = tr["spans"]
    order = np.argsort(tr["start"])
    starts = tr["start"][order]
    idle = {}
    for g0, g1 in zip(gap_s, gap_e):
        if g1 <= g0:
            continue
        k = np.searchsorted(spans[:, 0], g0, side="right") - 1
        where = tr["phases"][k] + " tick" \
            if k >= 0 and g0 < spans[k, 1] else "between ticks"
        j = np.searchsorted(starts, g1)
        nxt = names[order[j]] if j < len(order) else "end"
        label = f"{where}, before {str(nxt)[:80]}"
        idle[label] = idle.get(label, 0) + int(g1 - g0)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[short(n), d / 1e9] for n, d in ops],
            "idle_gaps": [[n, d / 1e9] for n, d in gaps]}
