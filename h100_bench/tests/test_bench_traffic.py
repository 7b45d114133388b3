"""The traffic generator: deterministic from the seed, the same work for
every seed, and the stated distributions."""
import json
from pathlib import Path

import numpy as np
import pytest

from h100_bench import traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat", "chat-tiers"])
def test_same_seed_same_requests(name):
    a = traffic.schedule(_mix(name), 1000, 2 ** 31 + 7, 20)
    b = traffic.schedule(_mix(name), 1000, 2 ** 31 + 7, 20)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.due == y.due and x.max_new == y.max_new
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", ["chat", "chat-tiers"])
def test_seeds_share_the_work_and_differ_in_tokens(name):
    a = traffic.schedule(_mix(name), 1000, 11, 20)
    b = traffic.schedule(_mix(name), 1000, 4_000_000_007, 20)
    assert [(r.due, len(r.prompt), r.max_new, r.tier) for r in a] \
        == [(r.due, len(r.prompt), r.max_new, r.tier) for r in b]
    assert not all(np.array_equal(x.prompt[:4], y.prompt[:4])
                   for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["chat", "chat-tiers"])
def test_lengths_follow_the_mix(name):
    mix = _mix(name)
    rng = np.random.default_rng(0)
    for key in ("prompt_len", "output_len"):
        spec = mix[key]
        v = traffic.lengths(spec, 20000, rng)
        assert v.min() >= spec["min"] and v.max() <= spec["max"]
        assert abs(np.median(v) / spec["median"] - 1) < 0.03
        # the lognormal's spread between the clips
        inner = v[(v > spec["min"]) & (v < spec["max"])]
        q = np.log(np.percentile(inner, [25, 75]))
        assert abs((q[1] - q[0]) / 1.349 / spec["sigma"] - 1) < 0.15


def test_poisson_rate_and_gaps():
    rng = np.random.default_rng(1)
    t = traffic.arrival_times({"process": "poisson", "rate_per_s": 5.0},
                              0.0, 2000.0, rng)
    assert abs(len(t) / 2000.0 / 5.0 - 1) < 0.03
    gaps = np.diff(t)
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05    # exponential


def test_bursts_carry_their_share():
    arr = {"process": "poisson", "rate_per_s": 10.0, "burst_every_s": 5.0,
           "burst_share": 0.25, "burst_len_s": 0.5}
    t = traffic.arrival_times(arr, 0.0, 5000.0, np.random.default_rng(2))
    assert abs(len(t) / 5000.0 / 10.0 - 1) < 0.03
    in_burst = np.mod(t, 5.0) < 0.5
    # a quarter in the bursts, plus the steady part's tenth of that time
    want = 0.25 + 0.75 * 0.1
    assert abs(in_burst.mean() / want - 1) < 0.05


def test_tiers_follow_the_dominant_one():
    mix = _mix("chat-tiers")
    s = traffic.schedule(mix, 1000, 5, 50)
    t = np.array([r.due for r in s]) + mix["preroll_s"]
    tier = np.array([r.tier for r in s])
    dom = np.floor(t / mix["tiers"]["rotate_s"]).astype(int) % 3
    share = (tier == dom).mean()
    assert abs(share - mix["tiers"]["dominant_share"]) < 0.06
    assert set(tier.tolist()) == {0, 1, 2}


def test_schedule_spans_preroll_and_window():
    mix = _mix("chat")
    s = traffic.schedule(mix, 1000, 5, 30)
    assert s[0].due >= -mix["preroll_s"] and s[-1].due < 30
    assert all(a.due <= b.due for a, b in zip(s, s[1:]))
    assert all(len(r.prompt) + r.max_new <= mix["serve"]["max_len"]
               for r in s)
