"""The comparison that decides ``correct``, on tiny float32 cells on the
CPU: the reference agrees with the port's logits through the whole timed
path (the dense family, with and without the library, the ``xla`` oracle
and the kernel backend's CPU version), each fault a served cell can
have, planted under the timed path, turns ``correct`` false, and so do
controllers that leave their policy and counts misread.  (The fault of
an exchange between chips left out has no place in a one-chip cell.)"""
import time

import numpy as np
import pytest
import torch

from h100_bench import check, harness
from h100_bench import reference as R
from h100_bench import weights as W
from h100_bench.tests.cells import StepClock, tiny

CELLS = [("internlm2-1.8b", "chat"), ("internlm2-1.8b", "chat-tiers")]


def _wrap_step(srv, wrap):
    """Every decode step the server takes (its static one, or each
    autotune rung's) goes through ``wrap(step)``."""
    active, done = srv._active_step, {}

    def step():
        s = active()
        if id(s) not in done:
            done[id(s)] = wrap(s)
        return done[id(s)]
    srv._active_step = step


def _run(cell, seed, fault=None, keep=None):
    with torch.no_grad():
        return harness.run_cell(cell, seed, 1.5, False, "cpu",
                                time.perf_counter(), fault=fault, keep=keep,
                                clock=StepClock())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("config,mix", CELLS)
def test_reference_agrees_with_the_served_logits(config, mix, backend):
    cell = tiny(config, mix, backend)
    seen = []

    def capture(srv):
        def wrap(step):
            def wrapped(params, cache, inputs, mask, **kw):
                who = [None if s is None or not mask[i]
                       or srv.remaining_prompt[i].size > 1
                       else (s.rid, len(s.out))
                       for i, s in enumerate(srv.slots)]
                logits, cache, m = step(params, cache, inputs, mask, **kw)
                seen.append((who, logits.float().clone()))
                return logits, cache, m
            return wrapped
        _wrap_step(srv, wrap)

    keep = {}
    line = _run(cell, 2 ** 32 + 5, capture, keep)
    assert line["correct"], line["check"]
    assert line["check"]["logit_gap"]["value"] <= 1e-4
    # the decode ticks' counts were held to the reference's routing
    assert line["_extra"]["counted_ticks"] >= 5
    kv = line["kv"]
    assert 0 < kv["pages_hwm"] <= kv["pages_pool"]
    assert kv["held_bytes"] * kv["pages_pool"] \
        == kv["pool_bytes"] * kv["pages_hwm"]
    cfg = harness.cell_config(cell)
    get = check.float32_view(W.draw(cfg, 2 ** 32 + 5, "cpu", torch.float32))
    seqs = check._sequences(keep["requests"], keep["requests"].keys())
    logits = lambda t: R.router_logits(cfg, get, torch.as_tensor(t)).numpy()
    decs = check.decisions(cfg, cell["traffic"]["serve"]["batch"],
                           keep["ticks"], seqs, logits, set(keep["sample"]),
                           {k: r["tier"] for k, r in keep["requests"].items()},
                           harness.margins_of(cfg, cell["traffic"]))
    if cell["traffic"]["serve"].get("autotune"):
        # the library's resident set moves during the run
        assert len({tuple(t.residency) for t in keep["ticks"]}) > 1
    else:
        assert any((d == -1).any() for d in decs.values()), \
            "the tiny cell should drop rows over capacity"
    q = keep["sample"][0]
    req, dec = keep["requests"][q], decs[q]
    assert (dec >= -1).all()
    prog = {}
    for who, lg in seen:
        for i, w in enumerate(who):
            if w is not None and w[0] == q:
                prog[w[1]] = lg[i]
    assert sorted(prog) == list(range(len(req["out"])))
    p_len = len(req["prompt"])
    at = torch.arange(p_len - 1, p_len - 1 + len(req["out"]))
    ref = R.logits(cfg, get, torch.as_tensor(seqs[q]),
                   torch.as_tensor(dec), at)
    got = torch.stack([prog[k] for k in range(len(req["out"]))])
    err = float((got - ref).abs().max() / ref.abs().max())
    # the kernel backend's CPU version takes its products tile by tile
    assert err < (2e-5 if backend == "xla" else 2e-4), err


def _state_unchanged(srv):
    """Each decode step hands back its KV cache as it was."""
    def wrap(step):
        def wrapped(params, cache, inputs, mask, **kw):
            keep = {k: cache[k].clone() for k in ("k", "v")}
            out = step(params, cache, inputs, mask, **kw)
            cache["k"].copy_(keep["k"])
            cache["v"].copy_(keep["v"])
            return out
        return wrapped
    _wrap_step(srv, wrap)


def _half_the_batch(srv):
    """Each decode tick computes half of its slots (the first half and
    the second on alternate ticks); the other half is served the tokens
    of the half computed, slot by slot."""
    orig, calls = srv._read_tick, [0]

    def wrapped(m, nxt, pos):
        calls[0] += 1
        b = nxt.shape[0]
        h = b // 2
        nxt = nxt.clone()
        if calls[0] % 2:
            nxt[h:2 * h] = nxt[:h]
        else:
            nxt[:h] = nxt[h:2 * h]
        return orig(m, nxt, pos)
    srv._read_tick = wrapped


def _token_altered(srv):
    """On each decode tick the token sampled for one busy slot, a
    different one each tick, is replaced where the server reads it by the
    one its logits rank last."""
    read, calls, last = srv._read_tick, [0], {}

    def wrap(step):
        def stepped(params, cache, inputs, mask, **kw):
            out = step(params, cache, inputs, mask, **kw)
            last["logits"] = out[0]
            return out
        return stepped

    def wrapped(m, nxt, pos):
        busy = [i for i, s in enumerate(srv.slots) if s is not None]
        calls[0] += 1
        if busy:
            i = busy[calls[0] % len(busy)]
            nxt = nxt.clone()
            nxt[i] = last["logits"][i].argmin()
        return read(m, nxt, pos)
    _wrap_step(srv, wrap)
    srv._read_tick = wrapped


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "token_altered"])
@pytest.mark.parametrize("config,mix", CELLS)
def test_each_fault_fails_the_check(config, mix, fault):
    plant = {"state_unchanged": _state_unchanged,
             "token_altered": _token_altered,
             "half_the_batch": _half_the_batch}[fault]
    line = _run(tiny(config, mix), 77, plant)
    assert not line["correct"], line["check"]
    assert line["check"]["logit_gap"]["value"] \
        > line["check"]["logit_gap"]["limit"]


def _residency_off_policy(srv):
    """Every fifth decode tick the library's resident slots are handed
    their classes in reverse order."""
    ctl, calls = srv.residency_controller, [0]
    observe = ctl.observe

    def wrapped(stats):
        calls[0] += 1
        r = observe(stats)
        return tuple(reversed(r)) if calls[0] % 5 == 0 else r
    ctl.observe = wrapped


def _rung_off_policy(srv):
    """After every decode tick the capacity controller moves one rung up
    from where its policy put it, wrapping round to the cheapest."""
    ctl = srv.controller
    observe = ctl.observe

    def wrapped(stats):
        ctl.index = (observe(stats) + 1) % len(ctl.ladder)
        return ctl.index
    ctl.observe = wrapped


def _counts_misread(srv):
    """The routed counts each decode tick hands the controllers are
    shifted by one class."""
    read = srv._read_tick

    def wrapped(m, nxt, pos):
        host = read(m, nxt, pos)
        host["class_counts"] = np.roll(host["class_counts"], 1)
        return host
    srv._read_tick = wrapped


@pytest.mark.parametrize("fault,key", [
    ("residency", "off_policy"), ("rung", "off_policy"),
    ("counts", "counts_off")])
def test_controllers_and_counts_are_held_to_the_reference(fault, key):
    plant = {"residency": _residency_off_policy, "rung": _rung_off_policy,
             "counts": _counts_misread}[fault]
    line = _run(tiny("internlm2-1.8b", "chat-tiers"), 91, plant)
    assert not line["correct"], line["check"]
    assert line["check"][key]["value"] > 0, line["check"]


def test_capacity_ranks_by_tick_and_class():
    cfg = {"approx": {"n_approx": 2, "exact_frac": 0.5, "invoke_frac": 0.25}}
    # batch 4: capacities 2 exact and 1 per approximator
    ticks = [check.Tick(0, np.array([[0, 0, 0, 1], [1, 1, 0, 1],
                                     [2, 2, 0, 1], [3, 3, 0, 1]])),
             check.Tick(0, np.array([[1, 1, 1, 1], [0, 0, 1, 1]]))]
    seqs = {0: np.array([5, 6]), 1: np.array([5, 7]), 2: np.array([5, 0]),
            3: np.array([5, 0])}
    # token 5 routes to approximator 1, every other token exact
    logits = lambda t: np.stack([np.asarray(t) != 5, np.asarray(t) == 5,
                                 np.zeros(len(t))], 1).astype(np.float32)
    d = check.decisions(cfg, 4, ticks, seqs, logits, {0, 1, 2, 3})
    # tick 0: four rows of class 1, one fits; tick 1: two exact rows fit
    assert [d[q][0] for q in range(4)] == [1, -1, -1, -1]
    assert d[0][1] == 0 and d[1][1] == 0
    assert d[2][1] == -2                # no tick carried it
