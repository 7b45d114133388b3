"""Per-request QoS tiers in the PyTorch port, against the JAX reference:
the single-device cases of tests/test_qos_tiers.py rerun on the port.

Both packages get the same numpy inputs and, at the engine level, the
SAME router logits, so tier vectors, plans and every count (class,
dispatched, per tier) are held exactly and floats within rtol = atol =
3e-5 (float32).  Inside the port the reference's own bitwise equalities
hold: a uniform zero-margin tier batch equals the untiered engine and
decode step.  Across backends the port is held within tolerance (the
reference's pallas == xla checks fail at ulp level on its own jax).
The server cases hold submit's validation, the ``qos_app`` anchor, the
mixed-tier drain summary at both scopes and the derived ladder equal.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.apps.registry import get_app as jget_app  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import autotune as JAT  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.apps.registry import get_app  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import autotune as AT  # noqa: E402
from repro_torch.runtime import dispatch as TD  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402
from repro_torch.sharding.rules import shard_capacity  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
LEGACY_KEYS = ("class_counts", "dispatched", "dropped", "exact_frac",
               "invocation", "executed_rows", "padding_rows")
COUNT_KEYS = ("class_counts", "dispatched", "dropped", "tier_counts",
              "tier_dispatched", "tier_dropped")
MARGINS = np.asarray([3.0, 0.0, -3.0], np.float32)   # tight / base / loose


def _case(seed, t, n, d, d_h):
    """Numpy inputs of one engine call: x, router logits, the stacks and
    the exact FFN's two matrices."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x = f(t, d, sc=0.5)
    logits = x @ f(d, n + 1, sc=0.5)
    w = [f(n, d, d_h, sc=0.2), f(n, d_h, sc=0.1), f(n, d_h, d, sc=0.2),
         f(n, d, sc=0.1)]
    return x, logits, w, (f(d, 2 * d, sc=0.1), f(2 * d, d, sc=0.1))


def _both(x, logits, w, ex, backend, **kw):
    """One mcma_dispatch call on each package; returns ((y, stats) jax,
    (y, stats) torch) as numpy."""
    wi, wo = ex
    jkw, tkw = {}, {}
    for k, v in kw.items():
        jkw[k] = jnp.asarray(v) if isinstance(v, np.ndarray) else v
        tkw[k] = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    jy, js = JD.mcma_dispatch(
        jnp.asarray(x), jnp.asarray(logits),
        lambda xb: jnp.dot(jax.nn.silu(jnp.dot(xb, wi)), wo),
        *map(jnp.asarray, w), backend=backend, block_t=32,
        interpret=backend != "xla", **jkw)
    tx = torch.from_numpy(x)
    twi, two = torch.from_numpy(wi), torch.from_numpy(wo)
    ty, ts = TD.mcma_dispatch(
        tx, torch.from_numpy(logits), lambda xb: F.silu(xb @ twi) @ two,
        *map(torch.from_numpy, w), backend=backend, block_t=32, **tkw)
    return ((np.asarray(jy), jax.tree.map(np.asarray, dict(js))),
            (ty.numpy(), {k: v.numpy() for k, v in ts.items()}))


def _assert_engine_equal(j, t, keys=COUNT_KEYS):
    np.testing.assert_allclose(t[0], j[0], **TOL)
    for k in keys:
        np.testing.assert_array_equal(t[1][k], j[1][k], err_msg=k)


def _mixed_tier(t, nt=3, seed=0):
    return np.random.default_rng(seed).integers(0, nt, t).astype(np.int32)


# ---------------------------------------------------------------------------
# uniform default tier == the margin-free engine, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_uniform_tier_engine_bitexact(backend, with_mask):
    t, n = 96, 3
    x, logits, w, ex = _case(11, t, n, 48, 16)
    kw = dict(exact_cap=t // 2, invoke_cap=max(int(t * 0.3), 1))
    if with_mask:
        kw["row_mask"] = np.arange(t) % 5 != 0
    j0, t0 = _both(x, logits, w, ex, backend, **kw)
    j1, t1 = _both(x, logits, w, ex, backend, tier=np.ones(t, np.int32),
                   tier_margins=MARGINS, **kw)
    np.testing.assert_array_equal(t0[0], t1[0])
    for k in LEGACY_KEYS:
        np.testing.assert_array_equal(t0[1][k], t1[1][k], err_msg=k)
    np.testing.assert_array_equal(t1[1]["tier_counts"][1],
                                  t1[1]["class_counts"])
    assert t1[1]["tier_counts"][[0, 2]].sum() == 0
    _assert_engine_equal(j1, t1)


def _models(**over):
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, **over))
    jcfg = enable(jsmoke(jget_config("internlm2-1.8b")))
    tcfg = enable(smoke_config(get_config("internlm2-1.8b")))
    if "p" not in _PARAMS:
        jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
        _PARAMS["p"] = (jp, params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return jcfg, tcfg, *_PARAMS["p"]


_PARAMS = {}


def _decode_pair(scope, backend, b, mask, tier=None, margins=None):
    jcfg, tcfg, jp, tp = _models(route_scope=scope, backend=backend,
                                 n_tiers=3, block_t=16)
    toks = np.arange(1, b + 1, dtype=np.int32)[:, None]
    jkw, tkw = {}, {}
    if tier is not None:
        jkw = dict(tier=jnp.asarray(tier), tier_margins=jnp.asarray(margins))
        tkw = dict(tier=torch.from_numpy(tier),
                   tier_margins=torch.from_numpy(margins))
    jl, _, jm = JM.decode(dataclasses.replace(jcfg, approx=dataclasses.replace(
        jcfg.approx, interpret=True)), jp, JM.init_cache(jcfg, b, 32),
        jnp.asarray(toks), serve=True, collect_metrics=True,
        row_mask=jnp.asarray(mask), **jkw)
    with torch.no_grad():
        tl, _, tm = TM.decode(tcfg, tp, TM.init_cache(tcfg, b, 32,
                                                      device="cpu"),
                              torch.from_numpy(toks), serve=True,
                              collect_metrics=True,
                              row_mask=torch.from_numpy(mask), **tkw)
    return (np.asarray(jl), jax.tree.map(np.asarray, jm)), \
        (tl.numpy(), {k: v.numpy() for k, v in tm.items()})


@pytest.mark.parametrize("route_scope", ["layer", "tick"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_uniform_tier_decode_step_bitexact(route_scope, backend):
    b = 4
    mask = np.asarray([True, True, False, True])
    _, t0 = _decode_pair(route_scope, backend, b, mask)
    j1, t1 = _decode_pair(route_scope, backend, b, mask,
                          np.ones(b, np.int32), MARGINS)
    np.testing.assert_array_equal(t0[0], t1[0])
    for k in ("class_counts", "dispatched"):
        np.testing.assert_array_equal(t0[1][k], t1[1][k], err_msg=k)
    np.testing.assert_allclose(t1[0], j1[0], **TOL)
    for k in ("class_counts", "dispatched", "tier_counts",
              "tier_dispatched"):
        np.testing.assert_array_equal(t1[1][k], j1[1][k], err_msg=k)


# ---------------------------------------------------------------------------
# mixed tiers: backends and the per-tier split
# ---------------------------------------------------------------------------

def test_mixed_tier_engine_backends_match_jax():
    t, n = 128, 3
    x, logits, w, ex = _case(3, t, n, 48, 16)
    kw = dict(exact_cap=t // 2, invoke_cap=max(int(t * 0.3), 1),
              tier=_mixed_tier(t), tier_margins=MARGINS)
    outs = {}
    for backend in ("xla", "pallas"):
        j, tt = _both(x, logits, w, ex, backend, **kw)
        _assert_engine_equal(j, tt)
        outs[backend] = tt
    np.testing.assert_allclose(outs["pallas"][0], outs["xla"][0], **TOL)
    for k in ("tier_counts", "tier_dispatched", "class_counts"):
        np.testing.assert_array_equal(outs["pallas"][1][k],
                                      outs["xla"][1][k])


def test_tier_split_sums_to_totals_and_is_monotone():
    t, n = 256, 3
    x, logits, w, ex = _case(7, t, n, 48, 16)
    j, tt = _both(x, logits, w, ex, "xla", exact_cap=t // 2,
                  invoke_cap=max(int(t * 0.25), 1),
                  row_mask=np.arange(t) % 7 != 0, tier=_mixed_tier(t),
                  tier_margins=MARGINS)
    _assert_engine_equal(j, tt)
    s = tt[1]
    np.testing.assert_array_equal(s["tier_counts"].sum(0), s["class_counts"])
    np.testing.assert_array_equal(s["tier_dispatched"].sum(0),
                                  s["dispatched"])
    assert s["tier_dropped"].sum() == s["dropped"]
    assert s["tier_counts"].dtype == np.int32
    served = s["tier_served_invocation"]
    np.testing.assert_allclose(served, j[1]["tier_served_invocation"], **TOL)
    assert served[2] > served[0], served
    routed = s["tier_counts"][:, 1:].sum(-1) / s["tier_counts"].sum(-1)
    assert routed[0] < routed[1] < routed[2], routed


@pytest.mark.parametrize("route_scope", ["layer", "tick"])
def test_mixed_tier_decode_backends_match_jax(route_scope):
    b = 6
    tier = np.asarray([0, 1, 2, 2, 1, 0], np.int32)
    mask = np.asarray([True] * 5 + [False])
    outs = {}
    for be in ("xla", "pallas"):
        j, tt = _decode_pair(route_scope, be, b, mask, tier, MARGINS)
        np.testing.assert_allclose(tt[0], j[0], **TOL)
        for k in ("tier_counts", "tier_dispatched", "class_counts"):
            np.testing.assert_array_equal(tt[1][k], j[1][k], err_msg=k)
        outs[be] = tt
    np.testing.assert_allclose(outs["pallas"][0], outs["xla"][0], **TOL)
    np.testing.assert_array_equal(outs["pallas"][1]["tier_counts"],
                                  outs["xla"][1]["tier_counts"])
    assert outs["xla"][1]["tier_counts"].sum() == 5


def test_tier_without_margins_or_n_tiers_fails_loudly():
    t = 32
    _, logits, _, _ = _case(2, t, 2, 32, 8)
    lg, tier = torch.from_numpy(logits), torch.from_numpy(_mixed_tier(t))
    with pytest.raises(AssertionError, match="tier_margins"):
        TD.make_dispatch_plan(lg, exact_cap=16, invoke_cap=8, tier=tier)
    p1 = TD.make_dispatch_plan(lg, exact_cap=16, invoke_cap=8, tier=tier,
                               n_tiers=3)
    p2 = TD.make_dispatch_plan(lg, exact_cap=16, invoke_cap=8, tier=tier,
                               tier_margins=torch.zeros(3))
    assert p1.n_tiers == p2.n_tiers == 3
    assert torch.equal(p1.tier_counts, p2.tier_counts)


def test_tier_margins_are_data_not_a_new_step():
    """One step object serves every margin setting: the margins are a
    tensor input, and flipping them changes the routing."""
    _, tcfg, _, tp = _models(route_scope="tick", n_tiers=3)
    from repro_torch.runtime import steps as TS
    step = TS.make_decode_step(tcfg, use_mcma_dispatch=True,
                               with_stats=True, backend="xla")
    b = 8
    tier = torch.from_numpy(_mixed_tier(b))
    toks = torch.arange(1, b + 1, dtype=torch.int32)[:, None]
    invs = []
    for m in ([8.0, 0.0, -8.0], [0.0, 0.0, 0.0], [-8.0, 0.0, 8.0]):
        cache = TM.init_cache(tcfg, b, 16, device="cpu")
        _, _, met = step(tp, cache, toks, None, tier, torch.tensor(m))
        invs.append(float(met["invocation"]))
    assert invs[0] != invs[2]


# ---------------------------------------------------------------------------
# asymmetric per-class capacities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_per_class_caps_clamp_each_class(backend):
    t, n = 128, 3
    x, logits, w, ex = _case(13, t, n, 48, 16)
    caps = (4, 40, 17)
    j, tt = _both(x, logits, w, ex, backend, exact_cap=t // 2,
                  invoke_cap=caps)
    _assert_engine_equal(j, tt, COUNT_KEYS + ("executed_rows",))
    s = tt[1]
    np.testing.assert_array_equal(s["dispatched"][1:],
                                  np.minimum(s["class_counts"][1:], caps))
    if backend == "xla":
        assert int(s["executed_rows"]) == t // 2 + sum(caps)


def test_per_class_caps_backends_match():
    t, n = 96, 3
    x, logits, w, ex = _case(17, t, n, 48, 16)
    outs = {b: _both(x, logits, w, ex, b, exact_cap=t // 2,
                     invoke_cap=(3, 29, 11))[1] for b in ("xla", "pallas")}
    np.testing.assert_allclose(outs["pallas"][0], outs["xla"][0], **TOL)


def test_uniform_tuple_caps_equal_scalar_cap():
    t, n = 80, 2
    x, logits, w, ex = _case(19, t, n, 32, 8)
    _, t1 = _both(x, logits, w, ex, "xla", exact_cap=40, invoke_cap=24)
    _, t2 = _both(x, logits, w, ex, "xla", exact_cap=40, invoke_cap=(24, 24))
    np.testing.assert_array_equal(t1[0], t2[0])
    np.testing.assert_array_equal(t1[1]["dispatched"], t2[1]["dispatched"])


def test_plan_from_asymmetric_operating_point():
    t, n = 80, 2
    _, logits, _, _ = _case(23, t, n, 32, 8)
    pt = AT.OperatingPoint(0.5, 0.3, invoke_fracs=(0.3, 0.1))
    jpt = JAT.OperatingPoint(0.5, 0.3, invoke_fracs=(0.3, 0.1))
    for backend in ("xla", "pallas"):
        plan = TD.make_dispatch_plan(torch.from_numpy(logits),
                                     operating_point=pt, backend=backend)
        jplan = JD.make_dispatch_plan(jnp.asarray(logits),
                                      operating_point=jpt, backend=backend)
        assert plan.class_caps == jplan.class_caps == (
            shard_capacity(t, 0.3), shard_capacity(t, 0.1))
        assert plan.exact_cap == jplan.exact_cap
        for f in JD._PLAN_DATA:
            np.testing.assert_array_equal(getattr(plan, f).numpy(),
                                          np.asarray(getattr(jplan, f)),
                                          err_msg=f)
    assert pt.cost(n) == pytest.approx(0.5 + 0.3 + 0.1) == jpt.cost(n)
    with pytest.raises(AssertionError, match="operating_point"):
        TD.make_dispatch_plan(torch.from_numpy(logits), exact_cap=4,
                              operating_point=pt)


# ---------------------------------------------------------------------------
# ladder_from_counts, margins, default bounds
# ---------------------------------------------------------------------------

def _skewed_counts(ticks=64, t=256):
    rng = np.random.default_rng(0)
    hot = rng.normal(150, 12, ticks).clip(0)
    mid = rng.normal(40, 8, ticks).clip(0)
    cold = rng.normal(6, 2, ticks).clip(0)
    exact = (t - hot - mid - cold).clip(0)
    return np.stack([exact, hot, mid, cold], -1), hot


def _as_dicts(ladder):
    return [dataclasses.asdict(p) for p in ladder]


def test_ladder_from_counts_skewed_mix():
    t, n = 256, 3
    counts, hot = _skewed_counts(t=t)
    ladder = AT.ladder_from_counts(counts, t)
    assert _as_dicts(ladder) == _as_dicts(JAT.ladder_from_counts(counts, t))
    assert len(ladder) >= 2
    for pt in ladder[:-1]:
        assert pt.invoke_fracs[0] > pt.invoke_fracs[1] \
            > pt.invoke_fracs[2], pt
    costs = [pt.cost(n) for pt in ladder]
    assert costs == sorted(costs)
    assert ladder[-1] == AT.OperatingPoint(1.0, 1.0,
                                           invoke_fracs=(1.0,) * n)
    uniform_cost = (0.5 + n * (np.quantile(hot, 0.5) * 1.1 / t))
    assert ladder[0].cost(n) < uniform_cost
    caps = AT.point_caps(ladder[-2], t, n)
    np.testing.assert_array_equal(
        caps, JAT.point_caps(JAT.ladder_from_counts(counts, t)[-2], t, n))
    drops = np.maximum(counts - caps, 0).sum()
    assert drops / counts.sum() < 0.05


def test_ladder_from_counts_single_observation_and_controller():
    counts = np.asarray([100.0, 140.0, 10.0, 6.0])
    ladder = AT.ladder_from_counts(counts, 256)
    jladder = JAT.ladder_from_counts(counts, 256)
    assert _as_dicts(ladder) == _as_dicts(jladder)
    ctrl = AT.CapacityController(
        ladder, lambda pt: AT.point_caps(pt, 256, 3), drop_budget=0.05)
    jctrl = JAT.CapacityController(
        jladder, lambda pt: JAT.point_caps(pt, 256, 3), drop_budget=0.05)
    idx = ctrl.observe({"class_counts": counts, "dropped": 0.0})
    assert idx == jctrl.observe({"class_counts": counts, "dropped": 0.0})
    assert 0 <= idx < len(ladder)


def test_margins_and_default_bounds():
    bounds = AT.default_tier_bounds(0.10)
    assert bounds == (0.05, 0.10, 0.20) == JAT.default_tier_bounds(0.10)
    m = AT.margins_from_bounds(bounds, 0.10, scale=4.0)
    assert m == JAT.margins_from_bounds(bounds, 0.10, scale=4.0)
    assert m[1] == pytest.approx(0.0)
    assert m[0] > 0 > m[2]
    assert m[0] == pytest.approx(-m[2])
    assert list(m) == sorted(m, reverse=True)
    for base, spread in ((0.05, 2.0), (0.3, 3.5)):
        assert AT.default_tier_bounds(base, spread) == \
            JAT.default_tier_bounds(base, spread)


# ---------------------------------------------------------------------------
# server: submit-time validation + per-tier drain summary
# ---------------------------------------------------------------------------

def _servers(**kw):
    """The port's and the reference's server on the same parameters."""
    jcfg, tcfg, jp, tp = _models()
    base = dict(batch=4, max_len=64, use_mcma_dispatch=True, backend="xla")
    base.update(kw)
    return (DecodeServer(tcfg, tp, options=ServeOptions(**base)),
            JServer(jcfg, jp, options=JOptions(**base)))


def test_submit_validates_error_bound():
    srv, jsrv = _servers(qos_tiers=(0.05, 0.10, 0.20))
    mk = lambda **kw: Request(rid=0, prompt=np.ones(3, np.int32), **kw)
    with pytest.raises(ValueError, match="tighter than the tightest"):
        srv.submit(mk(error_bound=0.01))
    with pytest.raises(ValueError, match="positive finite"):
        srv.submit(mk(error_bound=-0.1))
    with pytest.raises(ValueError, match="positive finite"):
        srv.submit(mk(error_bound=float("nan")))
    with pytest.raises(ValueError, match="out of range"):
        srv.submit(mk(tier=7))
    for eb, want in ((0.05, 0), (0.07, 0), (0.10, 1), (0.15, 1),
                     (0.20, 2), (0.9, 2)):
        r = mk(error_bound=eb)
        srv.submit(r)
        jr = JRequest(rid=0, prompt=np.ones(3, np.int32), error_bound=eb)
        jsrv.submit(jr)
        assert r.tier == jr.tier == want, (eb, r.tier, jr.tier)
    r = mk(tier=2)
    srv.submit(r)
    assert r.tier == 2
    np.testing.assert_array_equal(srv.tier_margins, jsrv.tier_margins)
    assert srv.default_tier == jsrv.default_tier == 1
    assert srv.cfg.approx.n_tiers == 3
    assert srv.cfg.approx.tier_margins == jsrv.cfg.approx.tier_margins


def test_submit_without_tier_table_fails_loudly():
    srv, _ = _servers()
    with pytest.raises(ValueError, match="no tier table"):
        srv.submit(Request(rid=0, prompt=np.ones(3, np.int32),
                           error_bound=0.1))
    with pytest.raises(ValueError, match="no tier table"):
        srv.submit(Request(rid=0, prompt=np.ones(3, np.int32), tier=0))


def test_qos_app_anchors_tier_table():
    srv, jsrv = _servers(qos_app="bessel")
    base = get_app("bessel").error_bound
    assert base == jget_app("bessel").error_bound
    assert srv.tier_bounds == AT.default_tier_bounds(base) == \
        jsrv.tier_bounds
    assert srv.tier_margins[1] == pytest.approx(0.0)
    np.testing.assert_array_equal(srv.tier_margins, jsrv.tier_margins)
    with pytest.raises(ValueError, match="bessel"):
        srv.submit(Request(rid=0, prompt=np.ones(3, np.int32),
                           error_bound=base / 100))


def test_admission_cost_weighs_tight_tiers():
    """Cost admission: at equal length and age the tightest tier costs
    1.5x, the loosest 1x, as in the reference."""
    srv, jsrv = _servers(qos_tiers=(0.05, 0.10, 0.20))
    for tier in (0, 1, 2, None):
        r = Request(rid=0, prompt=np.ones(10, np.int32), tier=tier)
        jr = JRequest(rid=0, prompt=np.ones(10, np.int32), tier=tier)
        srv.submit(r)
        jsrv.submit(jr)
        assert srv._admission_cost(r) == jsrv._admission_cost(jr)
    assert [srv._admission_cost(q) for q in srv.queue] == \
        [15.0, 12.5, 10.0, 12.5]


@pytest.mark.parametrize("route_scope", ["layer", "tick"])
def test_server_mixed_tier_drain_summary(route_scope):
    srv, jsrv = _servers(qos_tiers=(0.05, 0.10, 0.20),
                         route_scope=route_scope)
    rng = np.random.default_rng(0)
    bounds = [0.05, 0.10, 0.25, None]
    prompts = [rng.integers(0, 512, 5).astype(np.int32) for _ in range(6)]
    reqs = []
    for s, cls in ((srv, Request), (jsrv, JRequest)):
        rs = [cls(rid=i, prompt=p.copy(), max_new=4,
                  error_bound=bounds[i % len(bounds)])
              for i, p in enumerate(prompts)]
        for r in rs:
            s.submit(r)
        reqs.append(rs)
    stats, jstats = srv.run_until_drained(max_ticks=300), \
        jsrv.run_until_drained(max_ticks=300)
    assert all(r.done for r in reqs[0])
    assert [r.out for r in reqs[0]] == [r.out for r in reqs[1]]
    assert [r.tier for r in reqs[0]] == [r.tier for r in reqs[1]]
    per, jper = stats["per_tier"], jstats["per_tier"]
    for p, jp_ in zip(per, jper):
        for k in ("tier", "error_bound", "margin", "rows", "dropped_rows",
                  "served_invocation_rate", "routed_invocation_rate",
                  "dropped_frac"):
            assert p[k] == pytest.approx(jp_[k], abs=1e-12), (k, p, jp_)
    assert [p["tier"] for p in per] == [0, 1, 2]
    assert [p["error_bound"] for p in per] == [0.05, 0.10, 0.20]
    assert sum(p["rows"] for p in per) == pytest.approx(srv.active_sum)
    for p in per:
        assert 0.0 <= p["served_invocation_rate"] <= 1.0
        assert 0.0 <= p["dropped_frac"] <= 1.0
        assert p["rows"] > 0
    assert per[0]["served_invocation_rate"] \
        <= per[2]["served_invocation_rate"] + 1e-9
    assert stats["routed_per_class"] == jstats["routed_per_class"]
    assert stats["dispatched_per_class"] == jstats["dispatched_per_class"]
    ladder = srv.derived_ladder()
    assert _as_dicts(ladder) == _as_dicts(jsrv.derived_ladder())
    assert ladder[-1].exact_frac == 1.0
    assert all(len(pt.invoke_fracs) == srv.cfg.approx.n_approx
               for pt in ladder)
