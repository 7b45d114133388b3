"""The one traffic generator: an open-loop schedule of requests from a mix
file (``traffic/<mix>.json``) and a seed.

A mix fixes its shape with its own ``shape_seed``: the arrival times,
each request's prompt and output length and its QoS tier are the same
for every run seed, so runs of different seeds do the same work (drawn
in another order, they moved the window's rate and tails by 5 to 15%
between seeds against 1 to 3% between two runs of one seed).  The run
seed draws the token ids, and so, with the weights it also draws, the
routing.

Mix keys:
  shape_seed   int, the seed of the arrival times and the length pool
  preroll_s    seconds of the same traffic before the window (set-up)
  arrivals     {"process": "poisson", "rate_per_s": r}, optionally with
               "burst_every_s", "burst_share", "burst_len_s": one burst a
               period carrying that share of the period's mean requests
               within burst_len_s (the mean rate stays r)
  prompt_len,  {"dist": "lognormal", "median": m, "sigma": s, "min": a,
  output_len    "max": b}, rounded to whole tokens and clipped to [a, b]
  tiers        optional {"n": k, "dominant_share": p, "rotate_s": r}: each
               request's QoS tier, the dominant one (which turns every r
               seconds) with probability p, else one of the others
  serve        the DecodeServer's options for this mix
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Planned:
    """One request of the schedule; ``due`` is in seconds from the start
    of the measured window (negative in the pre-roll)."""

    idx: int
    due: float
    prompt: np.ndarray
    max_new: int
    tier: int | None = None


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng([int(w) % (1 << 63) for w in words])


def arrival_times(arrivals: dict, start: float, end: float,
                  rng: np.random.Generator, rate: float | None = None):
    """Sorted arrival times in [start, end) of a Poisson process at
    ``rate`` (default the mix's), with the mix's periodic bursts."""
    r = float(rate if rate is not None else arrivals["rate_per_s"])
    if arrivals.get("process", "poisson") != "poisson":
        raise ValueError(f"unknown arrival process {arrivals['process']!r}")
    share = float(arrivals.get("burst_share", 0.0))
    times = []

    def poisson(rate_, a, b):
        n = rng.poisson(rate_ * (b - a))
        times.extend(rng.uniform(a, b, n).tolist())

    poisson(r * (1.0 - share), start, end)
    if share:
        every = float(arrivals["burst_every_s"])
        width = float(arrivals["burst_len_s"])
        t = np.floor(start / every) * every
        while t < end:
            a, b = max(t, start), min(t + width, end)
            if b > a:
                poisson(r * share * every / width, a, b)
            t += every
    return np.sort(np.asarray(times, np.float64))


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec.get("dist", "lognormal") != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = float(spec["median"]) * np.exp(float(spec["sigma"])
                                       * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def schedule(mix: dict, vocab: int, seed: int, seconds: float,
             rate: float | None = None) -> list[Planned]:
    """Every request due in [-preroll_s, seconds), in due order."""
    shape = _rng(mix["shape_seed"], int(round(seconds * 1000)),
                 int(round((rate or 0) * 1000)))
    times = arrival_times(mix["arrivals"], -float(mix["preroll_s"]),
                          float(seconds), shape, rate)
    n = len(times)
    p_len = lengths(mix["prompt_len"], n, shape)
    o_len = lengths(mix["output_len"], n, shape)
    tiers = [None] * n
    if "tiers" in mix:
        tiers = tier_of(mix["tiers"], times + float(mix["preroll_s"]),
                        shape).tolist()
    tok = _rng(seed, 2)
    return [Planned(i, float(times[i]),
                    tok.integers(0, vocab, int(p_len[i]), dtype=np.int32),
                    int(o_len[i]), tiers[i]) for i in range(n)]


def tier_of(spec: dict, t: np.ndarray, rng: np.random.Generator):
    """Each arrival's tier: the dominant tier of its period (tier
    ``floor(t / rotate_s) mod n``) with probability ``dominant_share``,
    else one of the other tiers, evenly."""
    k = int(spec["n"])
    dom = np.floor(t / float(spec["rotate_s"])).astype(np.int64) % k
    other = (dom + 1 + rng.integers(0, k - 1, len(t))) % k
    return np.where(rng.random(len(t)) < float(spec["dominant_share"]),
                    dom, other)
