"""The serving controllers' policy, frozen: a copy of the port's
``runtime/autotune.py`` (``default_ladder``, ``CapacityController``,
``ResidencyController``) at the defaults of its ``runtime/options.py``
(``LibrarySpec``, ``ServeOptions.drop_budget``), kept here so that a
change to the port cannot move what the reference holds it to.

``replay`` feeds the copy the stats that the server handed its own
controllers, decode tick by decode tick from the server's construction,
and returns the capacity rung and resident set that the policy gives
after each.  The reference decides every row by these, not by what the
program's controllers chose, and ``check`` counts the ticks where the two
differ.  A rung is (exact_frac, per-class invoke fractions, slack), a
resident set a tuple of library ids.  Nothing here imports the port.
"""
from __future__ import annotations

import numpy as np

from h100_bench.check import capacity

# LibrarySpec's and CapacityController's defaults
LIBRARY = dict(promote_margin=1.5, demote_margin=0.25, observe_window=8,
               cooldown=16, ema=0.3, start=())
CAPACITY = dict(drop_budget=0.05, ema=0.5, down_patience=8, down_margin=0.5,
                cooldown=3)


def ladder(approx: dict, n: int) -> list:
    """The default ladder around the configuration's operating point: half
    of it, itself, 1.5 times it and full capacity, fractions clipped to 1,
    in order of cost, repeats dropped."""
    ef, iv = approx["exact_frac"], approx["invoke_frac"]
    sl = approx.get("shard_slack", 1.0)
    rungs = [(min(ef * 0.5, 1.0), min(iv * 0.5, 1.0)), (ef, iv),
             (min(ef * 1.5, 1.0), min(iv * 1.5, 1.0)), (1.0, 1.0)]
    out = []
    for e, i in sorted(rungs, key=lambda r: (r[0] + n * r[1]) * sl):
        p = (e, (i,) * n, sl)
        if not out or p != out[-1]:
            out.append(p)
    return out


class Capacity:
    """``CapacityController``: the rung for the next tick from each decode
    tick's routed class counts and dropped rows."""

    def __init__(self, rungs: list, t: int, start: int, drop_budget: float,
                 ema: float, down_patience: int, down_margin: float,
                 cooldown: int):
        self.rungs, self.t, self.index = rungs, t, start
        self.budget, self.alpha = drop_budget, ema
        self.patience, self.margin = down_patience, down_margin
        self.cooldown = cooldown
        self.tick, self.ema = 0, None
        self.down_ok, self.last_switch = 0, -10 ** 9
        self.hold, self.last_down = down_patience, None

    def caps(self, index: int) -> np.ndarray:
        ef, fr, sl = self.rungs[index]
        return np.asarray([capacity(self.t, ef, sl)]
                          + [capacity(self.t, f, sl) for f in fr], float)

    def predicted(self, counts: np.ndarray, index: int) -> float:
        t = float(counts.sum())
        if t <= 0:
            return 0.0
        return float(np.maximum(counts - self.caps(index), 0.0).sum()) / t

    def observe(self, counts, dropped: float):
        counts = np.asarray(counts, float)
        t = counts.sum()
        frac = float(dropped) / t if t > 0 else 0.0
        self.ema = frac if self.ema is None \
            else self.alpha * frac + (1 - self.alpha) * self.ema
        self.tick += 1
        if self.tick - self.last_switch <= self.cooldown:
            return
        top = len(self.rungs) - 1
        if self.ema > self.budget and self.index < top:
            target = next((j for j in range(self.index + 1, top + 1)
                           if self.predicted(counts, j) <= self.budget), top)
            self.switch(target)
        elif self.index > 0 and self.ema <= self.budget \
                and self.predicted(counts, self.index - 1) \
                <= self.budget * self.margin:
            self.down_ok += 1
            if self.down_ok >= self.hold:
                self.switch(self.index - 1)
        else:
            self.down_ok = 0

    def switch(self, to: int):
        if to > self.index and self.last_down is not None \
                and self.tick - self.last_down <= 4 * (self.cooldown + 1):
            self.hold = min(self.hold * 2, 1 << 10)
        elif to < self.index:
            self.last_down = self.tick
        self.index, self.down_ok = to, 0
        self.last_switch, self.ema = self.tick, None


class Residency:
    """``ResidencyController``: the resident set from each decode tick's
    routed counts over the whole library (column 0 exact)."""

    def __init__(self, library_size: int, n_resident: int,
                 promote_margin: float, demote_margin: float,
                 observe_window: int, cooldown: int, ema: float,
                 start: tuple):
        self.size, self.promote, self.demote = (library_size, promote_margin,
                                                demote_margin)
        self.window, self.cooldown, self.alpha = observe_window, cooldown, ema
        self.resident = tuple(start) if start else tuple(range(n_resident))
        self.tick, self.ema, self.last_swap = 0, None, -10 ** 9

    def observe(self, lib_counts):
        c = np.asarray(lib_counts, float)
        t = c.sum()
        if t > 0:
            shares = c[1:] / t
            self.ema = shares if self.ema is None \
                else self.alpha * shares + (1 - self.alpha) * self.ema
        self.tick += 1
        if self.ema is None or self.tick - self.last_swap <= self.cooldown \
                or self.tick % self.window != 0:
            return
        off = [c for c in range(self.size) if c not in self.resident]
        if not off:
            return
        hot = max(off, key=lambda c: self.ema[c])
        slot = int(np.argmin([self.ema[c] for c in self.resident]))
        cold = self.resident[slot]
        if self.ema[hot] > self.promote * max(float(self.ema[cold]), 1e-9) \
                and float(self.ema[cold]) <= self.demote:
            r = list(self.resident)
            r[slot] = int(hot)
            self.resident = tuple(r)
            self.last_swap = self.tick


def replay(cfg: dict, serve: dict, batch: int, stats: list) -> list:
    """[(resident set or None, rung or None)] after 0, 1, ... of the
    observations ``stats`` (each {"class_counts", "dropped", "lib_counts"}
    of one decode tick, in order)."""
    lib = serve.get("library")
    n = lib["n_resident"] if lib else cfg["approx"]["n_approx"]
    cap = res = None
    if serve.get("autotune"):
        if serve["autotune"] is not True or serve.get("autotune_kwargs"):
            raise ValueError("the frozen policy holds the default ladder "
                             "and controller only")
        rungs = ladder(cfg["approx"], n)
        a = cfg["approx"]
        base = (a["exact_frac"], (a["invoke_frac"],) * n,
                a.get("shard_slack", 1.0))
        kw = dict(CAPACITY, drop_budget=serve.get("drop_budget",
                                                  CAPACITY["drop_budget"]))
        cap = Capacity(rungs, batch, rungs.index(base) if base in rungs
                       else 0, **kw)
    if lib:
        res = Residency(**{**LIBRARY, **lib})

    def state():
        return (None if res is None else res.resident,
                None if cap is None else cap.rungs[cap.index])
    out = [state()]
    for s in stats:
        if cap is not None:
            cap.observe(s["class_counts"], s["dropped"])
        if res is not None and s.get("lib_counts") is not None:
            res.observe(s["lib_counts"])
        out.append(state())
    return out
