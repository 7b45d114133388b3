"""The frozen copy of the serving controllers' policy (``policy.py``)
against the port's controllers on the same stats: the same capacity rung
and the same resident set after every decode tick."""
import json
from pathlib import Path

import numpy as np
import pytest

from h100_bench import policy

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "internlm2-1.8b.json"


def _stats(seed, n_ticks, n_cls, batch, library=0):
    """Decode ticks whose routed mix drifts: the class shares wander, so
    that the hot library classes turn over, and busy stretches, which drop
    rows over capacity, alternate with light ones, which fit a cheaper
    rung, so that rungs move both ways."""
    rng = np.random.default_rng(seed)
    out, w = [], rng.random(max(n_cls, library + 1)) + 0.1
    for k in range(n_ticks):
        w = np.clip(w * np.exp(0.3 * rng.standard_normal(len(w))), 0.02, 50)
        busy = (k // 50) % 2 == 1
        rows = int(rng.integers(batch // 2, batch + 1) if busy
                   else rng.integers(2, batch // 6))
        lib = rng.multinomial(rows, w / w.sum()) if library else None
        cls = rng.multinomial(rows, w[:n_cls] / w[:n_cls].sum())
        dropped = rng.integers(rows // 8, rows // 3 + 1) if busy else 0
        out.append(dict(class_counts=cls, dropped=float(dropped),
                        lib_counts=lib))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_follows_the_port(seed):
    from repro_torch.configs.base import ApproxConfig
    from repro_torch.runtime import autotune as at
    cfg = json.loads(CONFIG.read_text())
    a = ApproxConfig(**cfg["approx"])
    n, batch = a.n_approx, 32
    ladder = at.default_ladder(type("C", (), {"approx": a})())
    base = at.OperatingPoint(a.exact_frac, a.invoke_frac, a.shard_slack)
    ctl = at.CapacityController(
        ladder, lambda pt: at.point_caps(pt, batch, n), drop_budget=0.05,
        start=ladder.index(base))
    stats = _stats(seed, 400, n + 1, batch)
    got = policy.replay(cfg, {"autotune": True, "drop_budget": 0.05},
                        batch, stats)
    want = []
    for s in [None] + stats:
        if s is not None:
            ctl.observe({"class_counts": s["class_counts"],
                         "dropped": s["dropped"]})
        p = ctl.point
        want.append((None, (p.exact_frac, p.class_fracs(n), p.shard_slack)))
    assert got == want
    assert len(ctl.history) >= 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_residency_follows_the_port(seed):
    from repro_torch.runtime import autotune as at
    from repro_torch.runtime.options import LibrarySpec
    cfg = json.loads(CONFIG.read_text())
    spec = LibrarySpec(6, 3)
    ctl = at.ResidencyController(spec)
    stats = _stats(seed, 600, 4, 32, library=6)
    got = policy.replay(cfg, {"library": {"library_size": 6,
                                          "n_resident": 3}}, 32, stats)
    want = [(ctl.residency, None)]
    for s in stats:
        want.append((tuple(ctl.observe({"lib_counts": s["lib_counts"]})),
                     None))
    assert got == want
    assert len(ctl.history) >= 2


def test_the_ladder_is_the_port_s():
    from repro_torch.configs.base import ApproxConfig
    from repro_torch.runtime import autotune as at
    cfg = json.loads(CONFIG.read_text())
    a = ApproxConfig(**cfg["approx"])
    port = at.default_ladder(type("C", (), {"approx": a})())
    assert policy.ladder(cfg["approx"], a.n_approx) == [
        (p.exact_frac, p.class_fracs(a.n_approx), p.shard_slack)
        for p in port]
