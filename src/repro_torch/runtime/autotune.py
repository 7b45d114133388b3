"""Online capacity autotuning and library residency from served
invoke_stats (counterpart of ``repro/runtime/autotune.py``, line for line
in plain Python and numpy).

``OperatingPoint`` is one rung of a capacity ladder (capacity fractions
are row budgets: a rung is its own step object in the server, built on
first use and reused); ``CapacityController`` picks the rung per decode
tick from the observed routed counts and dropped rows, keeping the
dropped-row EMA under ``drop_budget`` on the cheapest rung that does so
(jump up to the first rung predicted to fit, step down one rung after
``down_patience`` ticks of headroom, ``cooldown`` after a switch,
exponential down-backoff after a re-escalation).  ``margins_from_bounds``
and ``default_tier_bounds`` build the QoS tier table;
``ResidencyController`` promotes the hottest off-set library class over
the coldest resident behind a ratio and a floor gate.  The controllers
read host numpy arrays: the server reads each decode tick's counts from
the device to feed them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One rung of the capacity ladder — a full serve-capacity config.

    ``exact_frac``/``invoke_frac`` are the capacity fractions fixed in
    the rung's step (row budgets); ``shard_slack`` over-provisions per-shard
    budgets against cross-shard class skew (sharding/rules.shard_capacity).

    ``invoke_fracs`` (optional, length n_approx) replaces the single
    shared ``invoke_frac`` with an ASYMMETRIC per-class capacity vector —
    ``ladder_from_counts`` derives these from served class-count
    quantiles so a heavy-tailed mix buys its hot class capacity instead
    of padding every cold one.  ``tier_margins`` are the per-tier
    exact-logit router margins of this rung; unlike the capacity fields
    they are tensor inputs of the decode step (margins change routing,
    not budgets), so two rungs differing only in margins share one step
    object — the CapacityController invariant "capacities are per rung,
    one step each" is untouched.
    """

    exact_frac: float
    invoke_frac: float
    shard_slack: float = 1.0
    invoke_fracs: tuple = ()
    tier_margins: tuple = ()

    def class_fracs(self, n_approx: int) -> tuple:
        """Per-class invoke fractions, length ``n_approx``."""
        if self.invoke_fracs:
            assert len(self.invoke_fracs) == n_approx, \
                (self.invoke_fracs, n_approx)
            return tuple(self.invoke_fracs)
        return (self.invoke_frac,) * n_approx

    def cost(self, n_approx: int) -> float:
        """Relative executed capacity (rows of compute per input row)."""
        return (self.exact_frac + sum(self.class_fracs(n_approx))) \
            * self.shard_slack


def default_ladder(cfg) -> tuple[OperatingPoint, ...]:
    """A small ladder bracketing the static config's operating point.

    Rungs are ordered by cost: half capacity (light mixes), the static
    config itself, 1.5x headroom, and a full-capacity top rung that can
    never drop a row — the controller's escape hatch for adversarial
    mixes.  Capacity fractions saturate at 1.0 (a capacity past T never
    fills).
    """
    a = cfg.approx
    base = OperatingPoint(a.exact_frac, a.invoke_frac, a.shard_slack)
    rungs = (
        OperatingPoint(min(a.exact_frac * 0.5, 1.0),
                       min(a.invoke_frac * 0.5, 1.0), a.shard_slack),
        base,
        OperatingPoint(min(a.exact_frac * 1.5, 1.0),
                       min(a.invoke_frac * 1.5, 1.0), a.shard_slack),
        OperatingPoint(1.0, 1.0, a.shard_slack),
    )
    # dedup (e.g. exact_frac=1.0 collapses rungs) preserving cost order
    out: list[OperatingPoint] = []
    for r in sorted(rungs, key=lambda r: r.cost(a.n_approx)):
        if not out or r != out[-1]:
            out.append(r)
    return tuple(out)


def point_caps(pt: OperatingPoint, t_local: int, n_approx: int,
               n_shards: int = 1) -> np.ndarray:
    """GLOBAL per-class capacity vector (n_approx + 1,) of a rung — the
    same per-shard formula the dispatch paths use
    (sharding/rules.shard_capacity), summed over shards.  Asymmetric
    rungs (``invoke_fracs``) yield per-class entries."""
    from repro_torch.sharding.rules import shard_capacity
    ec = shard_capacity(t_local, pt.exact_frac, slack=pt.shard_slack)
    ics = [shard_capacity(t_local, f, slack=pt.shard_slack)
           for f in pt.class_fracs(n_approx)]
    return np.asarray([ec * n_shards] + [ic * n_shards for ic in ics],
                      float)


def ladder_from_counts(class_counts, t: int, *,
                       quantiles=(0.5, 0.75, 0.95), headroom: float = 1.1,
                       shard_slack: float = 1.0,
                       tier_margins: tuple = ()) \
        -> tuple[OperatingPoint, ...]:
    """Derive a capacity ladder from the SERVED class-count distribution.

    ``class_counts``: (ticks, n_approx + 1) per-tick routed counts (a
    server's ``routed_per_class`` history; a single (n_approx + 1,)
    vector is treated as one observation); ``t`` is the row count the
    counts were observed over (the server's batch).  For each quantile
    ``q`` one rung is built whose PER-CLASS capacity fraction is that
    class's q-quantile demand (x ``headroom``), so a heavy-tailed mix
    gets an asymmetric ``invoke_fracs`` vector — the hot class's budget
    grows while cold classes stop paying for padding the hand-picked
    shared ``invoke_frac`` forced on them (closes the ROADMAP "autotune
    the ladder itself" item).  A full-capacity escape rung is always
    appended; rungs are cost-ordered and deduped, exactly the contract
    ``CapacityController`` expects of ``default_ladder``.
    """
    c = np.asarray(class_counts, float)
    if c.ndim == 1:
        c = c[None]
    assert c.ndim == 2 and c.shape[1] >= 2, c.shape
    assert t > 0
    n = c.shape[1] - 1
    floor = 1.0 / t                         # shard_capacity's min of 1 row
    rungs = []
    for q in sorted(quantiles):
        demand = np.quantile(c, q, axis=0) * headroom / t
        ef = float(np.clip(demand[0], floor, 1.0))
        ifs = tuple(float(np.clip(v, floor, 1.0)) for v in demand[1:])
        rungs.append(OperatingPoint(ef, max(ifs), shard_slack,
                                    invoke_fracs=ifs,
                                    tier_margins=tuple(tier_margins)))
    rungs.append(OperatingPoint(1.0, 1.0, shard_slack,
                                invoke_fracs=(1.0,) * n,
                                tier_margins=tuple(tier_margins)))
    out: list[OperatingPoint] = []
    for r in sorted(rungs, key=lambda r: r.cost(n)):
        if not out or r != out[-1]:
            out.append(r)
    return tuple(out)


def margins_from_bounds(bounds, base_bound: float,
                        scale: float = 4.0) -> tuple[float, ...]:
    """Per-tier exact-logit margins from per-tier error bounds.

    The router was co-trained with labels computed at ``base_bound``, so
    its logits encode "best approximator beats the bound" at that one
    quality level.  A tier demanding a TIGHTER bound should win more
    borderline rows for the exact path (positive margin), a looser one
    fewer (negative): ``margin = scale * log(base_bound / bound)`` is the
    monotone log-odds-style map (zero exactly at the trained bound).
    ``scale`` calibrates logit units per factor-of-e of bound; the
    margins are tensor inputs of the serve steps, so recalibrating builds
    no new step.
    """
    assert base_bound > 0
    return tuple(float(scale * np.log(base_bound / b)) for b in bounds)


def default_tier_bounds(base_bound: float,
                        spread: float = 2.0) -> tuple[float, ...]:
    """Ascending (tight, base, loose) error-bound rungs bracketing a
    trained/base quality bound — the server's default QoS tier table."""
    assert base_bound > 0 and spread > 1.0
    return (base_bound / spread, base_bound, base_bound * spread)


@dataclasses.dataclass
class Switch:
    """One ladder move, recorded for the trajectory."""

    tick: int
    from_index: int
    to_index: int
    drop_ema: float


class CapacityController:
    """Selects the active ladder rung from per-tick global invoke_stats.

    ``caps_fn(point) -> (n+1,) global capacity vector`` tells the
    controller what each rung would dispatch (servers build it from their
    batch/mesh geometry via ``point_caps``).  ``observe`` consumes one
    tick's stats (``class_counts``, ``dropped`` — layer-meaned values are
    fine, the law is scale-free in t) and returns the rung index to use
    for the NEXT tick.
    """

    def __init__(self, ladder: Sequence[OperatingPoint],
                 caps_fn: Callable[[OperatingPoint], np.ndarray], *,
                 drop_budget: float = 0.05, ema: float = 0.5,
                 down_patience: int = 8, down_margin: float = 0.5,
                 cooldown: int = 3, start: int | None = None):
        assert len(ladder) >= 1
        assert 0.0 < drop_budget < 1.0
        self.ladder = tuple(ladder)
        self.caps_fn = caps_fn
        self.drop_budget = drop_budget
        self.ema_alpha = ema
        self.down_patience = down_patience
        self.down_margin = down_margin
        self.cooldown = cooldown
        self.index = start if start is not None else 0
        self.tick = 0
        self.drop_ema: float | None = None
        self.history: list[Switch] = []
        self._down_ok = 0
        self._last_switch = -10 ** 9
        self._down_hold = down_patience   # current (backed-off) patience
        self._last_down_tick = None       # tick of the latest down-switch

    @property
    def point(self) -> OperatingPoint:
        return self.ladder[self.index]

    def _predicted_drop_frac(self, counts: np.ndarray, index: int) -> float:
        """Drop fraction the observed routed mix would suffer at a rung
        (global counts vs global caps; optimistic under cross-shard skew,
        see module docstring)."""
        caps = np.asarray(self.caps_fn(self.ladder[index]), float)
        t = float(counts.sum())
        if t <= 0:
            return 0.0
        return float(np.maximum(counts - caps, 0.0).sum()) / t

    def observe(self, stats) -> int:
        """Consume one tick's stats dict; returns the rung for next tick.

        ``stats`` needs ``class_counts`` (n+1,) and ``dropped`` (scalar);
        extra keys are ignored so a server can pass its metric dict
        straight through.
        """
        counts = np.asarray(stats["class_counts"], float)
        dropped = float(np.asarray(stats["dropped"]))
        t = counts.sum()
        drop_frac = dropped / t if t > 0 else 0.0
        a = self.ema_alpha
        self.drop_ema = drop_frac if self.drop_ema is None \
            else a * drop_frac + (1 - a) * self.drop_ema
        self.tick += 1
        if self.tick - self._last_switch <= self.cooldown:
            return self.index

        if self.drop_ema > self.drop_budget \
                and self.index < len(self.ladder) - 1:
            # violated: jump to the first rung predicted to meet budget
            target = len(self.ladder) - 1
            for j in range(self.index + 1, len(self.ladder)):
                if self._predicted_drop_frac(counts, j) <= self.drop_budget:
                    target = j
                    break
            self._switch(target)
        elif self.index > 0 and self.drop_ema <= self.drop_budget \
                and self._predicted_drop_frac(counts, self.index - 1) \
                <= self.drop_budget * self.down_margin:
            # the EMA gate matters when pinned at the TOP rung: with no
            # rung left to climb, a violating mix must hold position, not
            # drift down on the occasional light tick's prediction
            self._down_ok += 1
            if self._down_ok >= self._down_hold:
                self._switch(self.index - 1)
        else:
            self._down_ok = 0
        return self.index

    def _switch(self, to_index: int):
        if to_index > self.index and self._last_down_tick is not None \
                and self.tick - self._last_down_tick \
                <= 4 * (self.cooldown + 1):
            # re-escalating right after a step-down: the prediction lied
            # for this mix — back off future down attempts exponentially
            self._down_hold = min(self._down_hold * 2, 1 << 10)
        elif to_index < self.index:
            self._last_down_tick = self.tick
        self.history.append(Switch(self.tick, self.index, to_index,
                                   float(self.drop_ema or 0.0)))
        self.index = to_index
        self._down_ok = 0
        self._last_switch = self.tick
        # the new rung changes the drop distribution; restart the EMA
        self.drop_ema = None

    def summary(self) -> dict:
        """Trajectory record for server stats / bench CSVs."""
        return {
            "final_index": self.index,
            "final_point": dataclasses.asdict(self.point),
            "switches": [dataclasses.asdict(s) for s in self.history],
            "drop_ema": self.drop_ema,
            "ticks": self.tick,
        }


@dataclasses.dataclass
class Swap:
    """One residency move (library promote/demote), recorded."""

    tick: int
    promoted: int            # library id entering the resident set
    demoted: int             # library id leaving it
    slot: int                # resident slot that changed owner
    hot_ema: float           # promoted class's routed-share EMA
    cold_ema: float          # demoted class's routed-share EMA


class ResidencyController:
    """Picks WHICH library classes are resident, beside the
    CapacityController's HOW MUCH capacity.

    The dispatch engine routes over the full approximator library but can
    only execute the ``n_resident`` classes whose weights occupy the
    prepadded stacks (runtime/dispatch.make_dispatch_plan residency fold;
    off-set classes fall back to exact).  This controller watches the
    served full-library demand histogram (``lib_counts`` in the
    invoke_stats — QoS-Nets' routed_per_class adaptation) and promotes
    the hottest off-set class over the coldest resident.  A swap is a new
    residency vector through the same step object
    (kernels/ops.gather_resident_stacks).

    Thrash hysteresis, two gates both required to swap:
      * ratio: the challenger's routed-share EMA must exceed
        ``promote_margin x`` the coldest resident's — a borderline class
        oscillating around parity never swaps;
      * floor: a resident serving more than ``demote_margin`` of total
        traffic is never demoted, whatever is knocking.
    Decisions fire once per ``observe_window`` observed ticks, suppressed
    for ``cooldown`` ticks after a swap (the EMA must re-converge on the
    new set before it is trusted again); at most one swap per decision.

    ``spec`` is a runtime/options.LibrarySpec; ``observe`` consumes one
    tick's stats (needs ``lib_counts``, (library_size + 1,) with entry 0
    the exact votes) and returns the CURRENT residency tuple of library
    ids — the server feeds it to the step each tick.
    """

    def __init__(self, spec):
        self.spec = spec
        self.residency: tuple[int, ...] = spec.initial_residency()
        self.tick = 0
        self.ema: np.ndarray | None = None   # (library_size,) routed shares
        self.history: list[Swap] = []
        self._last_swap = -10 ** 9

    def observe(self, stats) -> tuple[int, ...]:
        lib_counts = np.asarray(stats["lib_counts"], float)
        shares = lib_counts[1:]              # drop the exact column
        t = lib_counts.sum()
        if t > 0:
            shares = shares / t
            a = self.spec.ema
            self.ema = shares if self.ema is None \
                else a * shares + (1 - a) * self.ema
        self.tick += 1
        if self.ema is None \
                or self.tick - self._last_swap <= self.spec.cooldown \
                or self.tick % self.spec.observe_window != 0:
            return self.residency

        resident = set(self.residency)
        off = [c for c in range(self.spec.library_size)
               if c not in resident]
        if not off:
            return self.residency
        hot = max(off, key=lambda c: self.ema[c])
        slot = int(np.argmin([self.ema[c] for c in self.residency]))
        cold = self.residency[slot]
        eps = 1e-9
        if self.ema[hot] > self.spec.promote_margin \
                * max(float(self.ema[cold]), eps) \
                and float(self.ema[cold]) <= self.spec.demote_margin:
            self.history.append(Swap(self.tick, int(hot), int(cold), slot,
                                     float(self.ema[hot]),
                                     float(self.ema[cold])))
            r = list(self.residency)
            r[slot] = int(hot)
            self.residency = tuple(r)
            self._last_swap = self.tick
        return self.residency

    def summary(self) -> dict:
        """Trajectory record for server stats / bench CSVs."""
        return {
            "final_residency": list(self.residency),
            "swaps": [dataclasses.asdict(s) for s in self.history],
            "swap_count": len(self.history),
            "lib_ema": None if self.ema is None
            else [float(v) for v in self.ema],
            "ticks": self.tick,
        }
