"""Capacity rule shared by the serving paths (counterpart of the
``shard_capacity`` function of ``repro/sharding/rules.py``; the rest of
that module waits for the multi-device slice, ROADMAP queue 1 item 10).
"""
from __future__ import annotations


def shard_capacity(t_local: int, frac: float, *, slack: float = 1.0) -> int:
    """Per-shard capacity for a capacity fraction of a row batch:
    ``frac * t_local`` rows over-provisioned by ``slack``, clamped to
    ``[1, t_local]`` (capacity past t_local can never fill)."""
    return max(min(int(t_local * frac * slack), t_local), 1)
