"""The PyTorch port's tick-scope routing (``route_scope="tick"``) against
the JAX reference, on the smoke internlm2 config (ApproxFFN on, float32).

``make_tick_plan``'s plan tensors equal the reference's when both see the
same router logits (inputs whose products are exact in float32, so both
packages compute the same bits), with a per-slot and a (B, S) token mask;
the router logits of ordinary inputs agree within 3e-5; tick-scope decode
logits within 3e-5 of the reference's with equal stats; a tick's metrics
are its plan's stats; an unknown scope raises.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import approx_ffn as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import approx_ffn as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import dispatch as TD  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
PLAN_FIELDS = ("cls", "rank", "eff", "order", "pos", "tile_cls",
               "exact_keep", "exact_slot", "counts", "dispatched", "t_total")


def _cfgs(**over):
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, **over))
    return (enable(jsmoke(jget_config("internlm2-1.8b"))),
            enable(smoke_config(get_config("internlm2-1.8b"))))


_PARAMS = {}


def _models(**over):
    jcfg, tcfg = _cfgs(**over)
    if not _PARAMS:
        jp = JM.init_model(jax.random.PRNGKey(1), jcfg)
        _PARAMS["j"] = jp
        _PARAMS["t"] = params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, _PARAMS["j"], _PARAMS["t"]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("mask", ["none", "slot", "token"])
def test_make_tick_plan_matches_jax_on_the_same_logits(backend, mask):
    """x and the head hold multiples of 1/8 and 1/16 small enough that
    every router logit is exact in float32: both packages route on the
    same bits, so every plan tensor must be equal."""
    jcfg, tcfg = _cfgs(backend=backend, block_t=16)
    rng = np.random.default_rng(0)
    b, s, d = 4, 8, jcfg.d_model
    n1 = jcfg.approx.n_approx + 1
    x = (rng.integers(-8, 9, (b, s, d)) / 8).astype(np.float32)
    head = (rng.integers(-8, 9, (d, n1)) / 16).astype(np.float32)
    row_mask = {"none": None,
                "slot": np.asarray([True, False, True, True]),
                "token": rng.random((b, s)) < 0.7}[mask]
    jplan = JA.make_tick_plan(
        jcfg, {"tick_router": jnp.asarray(head)}, jnp.asarray(x),
        None if row_mask is None else jnp.asarray(row_mask))
    tplan = TA.make_tick_plan(
        tcfg, types.SimpleNamespace(tick_router=torch.from_numpy(head)),
        torch.from_numpy(x),
        None if row_mask is None else torch.from_numpy(row_mask))
    assert (tplan.exact_cap, tplan.invoke_cap, tplan.block_t) == \
        (jplan.exact_cap, jplan.invoke_cap, jplan.block_t)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                      np.asarray(getattr(jplan, f)),
                                      err_msg=f)
    tst = TD.plan_invoke_stats(tplan)
    from repro.runtime.dispatch import plan_invoke_stats
    jst = plan_invoke_stats(jplan)
    for k in ("class_counts", "dispatched", "dropped", "padding_rows"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "xla"])
def test_approx_ffn_serve_on_a_tick_plan_matches_jax(backend):
    """One layer's ApproxFFN executed against the same tick plan in both
    packages (exact-valued router inputs, as above): outputs within 3e-5,
    the returned stats equal the plan's."""
    jcfg, tcfg, jparams, tparams = _models()
    jcfg = JS.mcma_serve_config(jcfg, backend=backend)   # interpret on CPU
    tcfg = TS.mcma_serve_config(tcfg, backend=backend)
    rng = np.random.default_rng(5)
    b, s, d = 4, 8, jcfg.d_model
    n1 = jcfg.approx.n_approx + 1
    x = (rng.integers(-8, 9, (b, s, d)) / 8).astype(np.float32)
    head = (rng.integers(-8, 9, (d, n1)) / 16).astype(np.float32)
    mask = rng.random((b, s)) < 0.8
    jplan = JA.make_tick_plan(jcfg, {"tick_router": jnp.asarray(head)},
                              jnp.asarray(x), jnp.asarray(mask))
    tplan = TA.make_tick_plan(
        tcfg, types.SimpleNamespace(tick_router=torch.from_numpy(head)),
        torch.from_numpy(x), torch.from_numpy(mask))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["approx"])
    jy, ja = JA.approx_ffn_serve(jcfg, jp, jnp.asarray(x), plan=jplan)
    with torch.no_grad():
        ty, ta = TA.approx_ffn_serve(tcfg, tparams.blocks[0].approx,
                                     torch.from_numpy(x), plan=tplan)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    want = TD.plan_invoke_stats(tplan)
    for k in ("class_counts", "dispatched", "dropped", "padding_rows"):
        assert torch.equal(ta["invoke_stats"][k], want[k]), k
        np.testing.assert_array_equal(ta["invoke_stats"][k].numpy(),
                                      np.asarray(ja["invoke_stats"][k]))


def test_tick_router_logits_match_jax():
    jcfg, tcfg, jparams, tparams = _models()
    toks = np.random.default_rng(2).integers(1, 512, (4, 8)).astype(np.int32)
    jx = JM.L.embed_fwd(jcfg, jparams["embed"], jnp.asarray(toks))
    tx = TL.embed_fwd(tcfg, tparams.embed, torch.from_numpy(toks))
    jl = np.asarray(jnp.dot(jx, jparams["tick_router"]).astype(jnp.float32))
    tl = (tx @ tparams.tick_router).float()
    np.testing.assert_allclose(tl.numpy(), jl.reshape(tl.shape), **TOL)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "xla"])
def test_tick_decode_matches_jax(backend):
    """8 tick-scope decode ticks with 2 idle slots: logits within 3e-5,
    the tick's dispatch counts equal, greedy tokens equal."""
    jcfg, tcfg, jparams, tparams = _models()
    kw = dict(use_mcma_dispatch=True, with_stats=True, route_scope="tick",
              backend=backend)
    jstep = jax.jit(JS.make_decode_step(jcfg, **kw), donate_argnums=(1,))
    tstep = TS.make_decode_step(tcfg, **kw)
    b = 8
    jcache, tcache = JM.init_cache(jcfg, b, 16), \
        TM.init_cache(tcfg, b, 16, device="cpu")
    mask = np.asarray([True] * 6 + [False] * 2)
    toks = np.arange(1, b + 1, dtype=np.int32)[:, None]
    for tick in range(8):
        jl, jcache, jm = jstep(jparams, jcache, jnp.asarray(toks),
                               jnp.asarray(mask))
        tl, tcache, tm = tstep(tparams, tcache, torch.from_numpy(toks),
                               torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"tick {tick}")
        for k in ("class_counts", "dispatched", "dropped_rows",
                  "padding_rows"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=f"{k} tick {tick}")
        assert int(tm["class_counts"].sum()) == 6
        np.testing.assert_allclose(float(tm["invocation"]),
                                   float(jm["invocation"]), atol=1e-6)
        nxt = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        toks = nxt.astype(np.int32)[:, None]


def test_tick_decode_metrics_are_the_plan_stats():
    """Every layer executes the one plan, so the step's metrics are the
    plan's stats exactly (the counterpart of tests/test_dispatch_plan.py's
    test_tick_decode_metrics_are_the_plan_stats)."""
    _, tcfg, _, tparams = _models(route_scope="tick", backend="pallas")
    b = 4
    cache = TM.init_cache(tcfg, b, 32, device="cpu")
    toks = torch.arange(1, b + 1, dtype=torch.int32)[:, None]
    x = TL.embed_fwd(tcfg, tparams.embed, toks)
    want = TD.plan_invoke_stats(TA.make_tick_plan(tcfg, tparams, x))
    with torch.no_grad():
        _, _, m = TM.decode(tcfg, tparams, cache, toks, serve=True,
                            collect_metrics=True)
    for k in ("class_counts", "dispatched", "tier_counts", "lib_counts"):
        assert torch.equal(m[k], want[k].float()), k
    assert float(m["dropped_rows"]) == float(want["dropped"])
    assert float(m["invocation"]) == float(want["invocation"])


def test_unknown_route_scope_raises():
    _, tcfg, _, tparams = _models()
    with pytest.raises(ValueError, match="route_scope"):
        TS.make_decode_step(tcfg, route_scope="ticks")
    with pytest.raises(ValueError, match="route_scope"):
        TS.make_prefill_chunk_step(tcfg, route_scope="ticks")
    cfg = dataclasses.replace(tcfg, approx=dataclasses.replace(
        tcfg.approx, route_scope="Tick"))
    cache = TM.init_cache(cfg, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="route_scope"):
        TM.decode(cfg, tparams, cache, torch.ones((2, 1), dtype=torch.int32),
                  serve=True)
