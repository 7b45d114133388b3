"""Capacity autotune in the PyTorch port, against the JAX reference: the
single-device cases of tests/test_autotune.py rerun on the port.

The controller is plain Python over host counts, so its law is replayed
on the same stats sequences in both packages (equal rung indices, switch
histories and summaries).  The engine cases feed both packages the same
numpy inputs and router logits: counts exactly, floats within rtol = atol
= 3e-5 (float32).  The server cases hold the rung trajectory, the tokens
and the drain counters equal, and the step objects built equal to the
rungs visited.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import autotune as JAT  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import autotune as AT  # noqa: E402
from repro_torch.runtime import dispatch as TD  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
LADDER = ((0.5, 0.1), (0.5, 0.3), (1.0, 1.0))


# ---------------------------------------------------------------------------
# the controller law, replayed in both packages
# ---------------------------------------------------------------------------

class Pair:
    """The port's and the reference's CapacityController side by side;
    ``observe`` feeds both and holds their rungs equal."""

    def __init__(self, ladder=LADDER, t=100, n=3, **kw):
        kw.setdefault("cooldown", 0)
        kw.setdefault("down_patience", 2)
        self.t = AT.CapacityController(
            tuple(AT.OperatingPoint(*p) for p in ladder),
            lambda pt: AT.point_caps(pt, t, n), drop_budget=0.05, **kw)
        self.j = JAT.CapacityController(
            tuple(JAT.OperatingPoint(*p) for p in ladder),
            lambda pt: JAT.point_caps(pt, t, n), drop_budget=0.05, **kw)

    def observe(self, stats):
        idx = self.t.observe(stats)
        assert idx == self.j.observe(stats)
        assert self.t.summary() == self.j.summary()
        return idx

    @property
    def index(self):
        return self.t.index


def test_controller_steps_up_to_first_sufficient_rung():
    c = Pair()
    s = {"class_counts": np.asarray([40., 60., 0., 0.]), "dropped": 50.0}
    assert c.observe(s) == 2
    assert c.t.history[0].from_index == 0 and c.t.history[0].to_index == 2


def test_controller_steps_down_with_patience_and_hysteresis():
    c = Pair(start=2)
    light = {"class_counts": np.asarray([45., 4., 3., 3.]), "dropped": 0.0}
    assert [c.observe(light) for _ in range(4)] == [2, 1, 1, 0]


def test_controller_cooldown_blocks_consecutive_switches():
    c = Pair(cooldown=3)
    hot = {"class_counts": np.asarray([0., 100., 0., 0.]), "dropped": 90.0}
    assert c.observe(hot) == 2
    light = {"class_counts": np.asarray([45., 0., 0., 0.]), "dropped": 0.0}
    for _ in range(3):
        assert c.observe(light) == 2
    for _ in range(2):
        c.observe(light)
    assert c.index == 1


def test_controller_backoff_dampens_thrash():
    c = Pair(down_patience=1)
    ok = {"class_counts": np.asarray([45., 5., 0., 0.]), "dropped": 0.0}
    bad = {"class_counts": np.asarray([45., 5., 0., 0.]), "dropped": 40.0}
    c.t.index = c.j.index = 1
    downs = []
    for _ in range(64):
        c.observe(bad if c.index == 0 else ok)
        h = c.t.history
        if h and h[-1].to_index < h[-1].from_index \
                and (not downs or h[-1].tick != downs[-1]):
            downs.append(h[-1].tick)
    assert len(downs) >= 2
    gaps = np.diff(downs)
    assert (gaps[1:] >= gaps[:-1]).all(), gaps
    assert c.t._down_hold > 1 and c.t._down_hold == c.j._down_hold


def test_controller_random_stream_replays_equal():
    rng = np.random.default_rng(3)
    c = Pair(cooldown=2, down_patience=3)
    for _ in range(300):
        counts = rng.multinomial(100, rng.dirichlet(np.ones(4) * 0.7))
        c.observe({"class_counts": counts.astype(float),
                   "dropped": float(rng.integers(0, 30))})
    assert c.t.history


def _smoke_cfgs(**over):
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, **over))
    return (enable(jsmoke(jget_config("internlm2-1.8b"))),
            enable(smoke_config(get_config("internlm2-1.8b"))))


def test_default_ladder_ordered_and_bracketing():
    jcfg, tcfg = _smoke_cfgs()
    lad = AT.default_ladder(tcfg)
    assert [dataclasses.asdict(p) for p in lad] == \
        [dataclasses.asdict(p) for p in JAT.default_ladder(jcfg)]
    a = tcfg.approx
    costs = [p.cost(a.n_approx) for p in lad]
    assert costs == sorted(costs)
    assert AT.OperatingPoint(a.exact_frac, a.invoke_frac, a.shard_slack) \
        in lad
    assert lad[-1] == AT.OperatingPoint(1.0, 1.0, a.shard_slack)
    assert len(set(lad)) == len(lad)
    for pt in lad:
        np.testing.assert_array_equal(
            AT.point_caps(pt, 8, 3),
            JAT.point_caps(JAT.OperatingPoint(**dataclasses.asdict(pt)), 8,
                           3))


# ---------------------------------------------------------------------------
# the free-slot bias fix: masked dispatch == dense sub-batch
# ---------------------------------------------------------------------------

def _case(seed, t, n, d, d_h):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x = f(t, d, sc=0.5)
    logits = x @ f(d, n + 1, sc=0.5)
    w = [f(n, d, d_h, sc=0.2), f(n, d_h, sc=0.1), f(n, d_h, d, sc=0.2),
         f(n, d, sc=0.1)]
    wi, wo = torch.from_numpy(f(d, 2 * d, sc=0.1)), \
        torch.from_numpy(f(2 * d, d, sc=0.1))
    return (torch.from_numpy(x), torch.from_numpy(logits),
            [torch.from_numpy(a) for a in w],
            lambda xb: F.silu(xb @ wi) @ wo)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_half_empty_mask_equals_dense_batch(backend):
    t, n = 128, 3
    x, logits, w, exact_fn = _case(3, t, n, 48, 16)
    kw = dict(exact_cap=t // 2, invoke_cap=t // 3, backend=backend,
              block_t=32)
    mask = torch.arange(t) < t // 2
    ym, sm = TD.mcma_dispatch(x, logits, exact_fn, *w, row_mask=mask, **kw)
    yd, sd = TD.mcma_dispatch(x[:t // 2], logits[:t // 2], exact_fn, *w,
                              **kw)
    for k in ("class_counts", "dispatched", "dropped"):
        assert torch.equal(sm[k], sd[k]), k
    assert float(sm["invocation"]) == pytest.approx(float(sd["invocation"]),
                                                    abs=1e-7)
    assert int(sm["class_counts"].sum()) == t // 2
    np.testing.assert_allclose(ym[:t // 2].numpy(), yd.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not ym[t // 2:].any()


def test_all_false_mask_reports_zero_invocation():
    t = 64
    x, logits, w, exact_fn = _case(6, t, 2, 32, 8)
    y, s = TD.mcma_dispatch(x, logits, exact_fn, *w, exact_cap=16,
                            invoke_cap=16, backend="xla",
                            row_mask=torch.zeros(t, dtype=torch.bool))
    assert float(s["invocation"]) == 0.0 and float(s["exact_frac"]) == 0.0
    assert int(s["class_counts"].sum()) == 0
    assert not y.any()


def test_all_true_mask_is_identity():
    t = 96
    x, logits, w, exact_fn = _case(4, t, 2, 32, 8)
    kw = dict(exact_cap=t // 2, invoke_cap=t // 3, backend="xla")
    y0, s0 = TD.mcma_dispatch(x, logits, exact_fn, *w, **kw)
    y1, s1 = TD.mcma_dispatch(x, logits, exact_fn, *w,
                              row_mask=torch.ones(t, dtype=torch.bool), **kw)
    assert torch.equal(y0, y1)
    assert torch.equal(s0["class_counts"], s1["class_counts"])


# ---------------------------------------------------------------------------
# autotune on a skewed mix, single-device engine, both packages
# ---------------------------------------------------------------------------

def _hot_logits(rng, t, n, hot, hot_frac):
    cls = np.where(rng.random(t) < hot_frac, hot, rng.integers(0, n + 1, t))
    return (np.eye(n + 1, dtype=np.float32)[cls] * 10.0)


def test_autotune_converges_under_budget_and_beats_static():
    """Skewed mix where the static rung drops >10% of approximable rows:
    the port's controller settles under the budget with more served
    approximator rows than static, the reference's controller, fed the
    reference engine's stats on the same logits, visits the same rungs,
    and the two kernel backends agree at every visited rung."""
    t, n, budget = 256, 3, 0.05
    x, _, w, exact_fn = _case(11, t, n, 48, 16)
    jx, jw = jnp.asarray(x.numpy()), [jnp.asarray(a.numpy()) for a in w]
    ladder = ((0.5, 0.15), (0.5, 0.35), (1.0, 1.0))
    c = Pair(ladder, t=t, n=n, cooldown=1, down_patience=4)

    def caps(idx):
        pt = ladder[idx]
        return dict(exact_cap=max(int(t * pt[0]), 1),
                    invoke_cap=max(int(t * pt[1]), 1))

    rng = np.random.default_rng(5)
    static_drop = static_served = tuned_served = 0.0
    drops, rungs = [], []
    for _ in range(16):
        lg = _hot_logits(rng, t, n, hot=n, hot_frac=0.8)
        rungs.append(c.index)
        yx, sx = TD.mcma_dispatch(x, torch.from_numpy(lg), exact_fn, *w,
                                  backend="xla", **caps(c.index))
        yp, sp = TD.mcma_dispatch(x, torch.from_numpy(lg), exact_fn, *w,
                                  backend="pallas", block_t=32,
                                  **caps(c.index))
        np.testing.assert_allclose(yp.numpy(), yx.numpy(), **TOL)
        _, js = JD.mcma_dispatch(jx, jnp.asarray(lg), lambda xb: xb, *jw,
                                 backend="xla", **caps(c.j.index))
        for k in ("class_counts", "dispatched", "dropped"):
            np.testing.assert_array_equal(sx[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(sp[k].numpy(), sx[k].numpy())
        _, ss = TD.mcma_dispatch(x, torch.from_numpy(lg), exact_fn, *w,
                                 backend="xla", **caps(0))
        static_drop += float(ss["dropped"])
        static_served += float(ss["dispatched"][1:].sum())
        tuned_served += float(sx["dispatched"][1:].sum())
        drops.append(float(sx["dropped"]) / t)
        c.observe({"class_counts": sx["class_counts"].numpy(),
                   "dropped": float(sx["dropped"])})
    approximable = 0.8 * t * 16
    assert static_drop / approximable > 0.10
    assert np.mean(drops[-4:]) <= budget
    assert tuned_served > static_served
    assert c.index > 0 and len(set(rungs)) > 1


# ---------------------------------------------------------------------------
# DecodeServer
# ---------------------------------------------------------------------------

_PARAMS = {}


def _models():
    jcfg, tcfg = _smoke_cfgs()
    if not _PARAMS:
        jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
        _PARAMS["p"] = (jp, params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return jcfg, tcfg, *_PARAMS["p"]


def _serve(cls, req_cls, opts_cls, cfg, params, prompts, max_new=4, **kw):
    srv = cls(cfg, params, options=opts_cls(use_mcma_dispatch=True,
                                            max_len=64, backend="xla", **kw))
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    return srv, reqs, srv.run_until_drained(300)


def test_server_half_empty_table_matches_batch1_invocation():
    _, tcfg, _, tp = _models()
    prompt = np.arange(1, 9, dtype=np.int32)
    outs = []
    for batch in (1, 4):
        _, reqs, stats = _serve(DecodeServer, Request, ServeOptions, tcfg,
                                tp, [prompt], max_new=5, batch=batch)
        outs.append((reqs[0].out, stats["invocation_rate"],
                     stats["served_invocation_rate"]))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == pytest.approx(outs[1][1], abs=1e-9)
    assert outs[0][2] == pytest.approx(outs[1][2], abs=1e-9)


def _check_server(stats, jstats, reqs, jreqs, n_rungs):
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    at, jat = stats["autotune"], jstats["autotune"]
    assert at == jat, (at, jat)
    assert 0 <= at["final_index"] < n_rungs
    for s in at["switches"]:
        assert 0 <= s["from_index"] < n_rungs
        assert 0 <= s["to_index"] < n_rungs
    for k in ("dropped_rows", "routed_per_class", "dispatched_per_class",
              "ticks", "prefill_ticks"):
        assert stats[k] == jstats[k], k
    disp = np.asarray(stats["dispatched_per_class"])
    routed = np.asarray(stats["routed_per_class"])
    assert (disp <= routed + 1e-6).all()
    assert 0.0 <= stats["served_invocation_rate"] <= 1.0


def _visited(at) -> set:
    """The rungs a decode tick ran on: the start, and every switch's
    target but one made at the last observed tick."""
    sw = at["switches"]
    start = sw[0]["from_index"] if sw else at["final_index"]
    return {start} | {s["to_index"] for s in sw if s["tick"] < at["ticks"]}


def test_server_autotune_end_to_end_reports_trajectory():
    jcfg, tcfg, jp, tp = _models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 5).astype(np.int32) for _ in range(3)]
    kw = dict(batch=2, drop_budget=0.05,
              autotune_kwargs=dict(cooldown=1, down_patience=4))
    ladder = ((0.25, 0.1), (1.0, 1.0))
    srv, reqs, stats = _serve(
        DecodeServer, Request, ServeOptions, tcfg, tp, prompts,
        autotune=tuple(AT.OperatingPoint(*p) for p in ladder), **kw)
    _, jreqs, jstats = _serve(
        JServer, JRequest, JOptions, jcfg, jp, prompts,
        autotune=tuple(JAT.OperatingPoint(*p) for p in ladder), **kw)
    _check_server(stats, jstats, reqs, jreqs, len(ladder))
    assert stats["autotune"]["ticks"] == stats["ticks"]
    assert set(srv._steps) == _visited(stats["autotune"])


def test_server_default_ladder_tick_chunked_matches_jax():
    """The default ladder at tick scope with chunked prefill and a paged
    cache: equal trajectory, tokens and counters; one decode step and one
    chunk step per visited rung (prefill runs at decode's rung)."""
    jcfg, tcfg, jp, tp = _models()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (3, 9, 17, 5, 12, 25)]
    kw = dict(batch=4, autotune=True, drop_budget=0.05, route_scope="tick",
              prefill_chunk=8, kv_page_size=8,
              autotune_kwargs=dict(cooldown=1, down_patience=2))
    srv, reqs, stats = _serve(DecodeServer, Request, ServeOptions, tcfg, tp,
                              prompts, max_new=6, **kw)
    _, jreqs, jstats = _serve(JServer, JRequest, JOptions, jcfg, jp,
                              prompts, max_new=6, **kw)
    n = len(AT.default_ladder(tcfg))
    _check_server(stats, jstats, reqs, jreqs, n)
    visited = _visited(stats["autotune"])
    assert set(srv._steps) == visited
    assert set(srv._chunk_steps) <= visited and srv._chunk_steps
