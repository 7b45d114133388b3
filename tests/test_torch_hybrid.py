"""The PyTorch port's zamba2 hybrid against the JAX reference, on the smoke
zamba2-2.7b config (float32: 4 Mamba2 layers in 2 groups, the shared
attention+FFN block applied twice), from JAX-initialized parameters,
perturbed where they start constant (tests/test_torch_archs.perturb),
converted into the port.

Held: ``mamba_fwd`` (the chunked SSD with and without an incoming state,
the one-token update) within 3e-5 in its outputs and final state, its
gradients within 1e-4 and finite where the masked upper triangle
overflows; the hybrid decode with the ApproxFFN at both route scopes
(the reference's test_hybrid_decode_collects_dispatch_metrics: metrics
present, counts summing to the active rows), the port's ``pallas``
backend within 3e-5 of the reference's ``xla`` and bitwise equal to its
``pallas_fused``, ``pos`` exactly; ``DecodeServer`` at tick scope, which
feeds the prompts token by token whatever ``prefill_chunk`` asks, with
greedy tokens and drain counters equal to the reference's server; and
the reference's slot-reset test (tests/test_runtime.py) on olmo-1b and
the hybrid.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import mamba2 as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import mamba2 as TMB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402
from test_torch_archs import models, perturb  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "zamba2-2.7b"


def _cfgs(approx=False, **over):
    def f(cfg):
        if approx:
            cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
                cfg.approx, enable=True, **over))
        return cfg
    return f(jsmoke(jget_config(ARCH))), f(smoke_config(get_config(ARCH)))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# mamba_fwd
# ---------------------------------------------------------------------------

def _mamba(seed=0, **set_leaves):
    """One Mamba2 core's perturbed parameters: (reference dict of jnp,
    the port's module), ``set_leaves`` overriding leaves by value."""
    jcfg, tcfg = _cfgs()
    tree = perturb({"core": jax.tree.map(
        np.asarray, JMB.init_mamba(jax.random.PRNGKey(seed), jcfg))},
        seed + 1)["core"]
    for k, v in set_leaves.items():
        tree[k] = np.full_like(tree[k], v)
    core = TMB.Mamba(tcfg, "cpu")
    core.load_state_dict({k: to_torch(v) for k, v in tree.items()})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), core


def _u(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("case", ["chunked", "chunked_state", "step"])
def test_mamba_fwd_matches_jax(case):
    """S 64 over chunks of 32, from zeros or from a state; the S == 1
    update from a state."""
    jcfg, tcfg, jp, core = _mamba()
    assert tcfg.ssm.chunk == 32
    s = 1 if case == "step" else 64
    u = _u((2, s, tcfg.d_model), 2)
    h0 = None
    if case != "chunked":
        _, n_heads, p_hd, n = TMB.mamba_dims(tcfg)
        h0 = _u((2, n_heads, p_hd, n), 3)
    jy, jst = JMB.mamba_fwd(jcfg, jp, jnp.asarray(u),
                            None if h0 is None else {"h": jnp.asarray(h0)})
    with torch.no_grad():
        ty, tst = TMB.mamba_fwd(tcfg, core, torch.from_numpy(u),
                                None if h0 is None
                                else {"h": torch.from_numpy(h0)})
    assert ty.shape == (2, s, tcfg.d_model) and tst["h"].dtype == \
        torch.float32
    _close(ty, jy, 3e-5, "y")
    _close(tst["h"], jst["h"], 3e-5, "h")


@pytest.mark.parametrize("overflow", [False, True])
def test_mamba_grads_match_jax(overflow):
    """Gradients of a fixed projection of y and the final state (a mean,
    as the LM loss is), wrt the input and every parameter, within 1e-4 of
    the reference's.  With a
    large ``a_log`` and ``dt_bias`` the within-chunk log-decays reach the
    thousands, so the masked upper triangle would overflow ``exp``: the
    mask before the exp keeps every gradient finite."""
    big = dict(a_log=5.0, dt_bias=5.0) if overflow else {}
    jcfg, tcfg, jp, core = _mamba(seed=4, **big)
    u = _u((2, 64, tcfg.d_model), 5)
    ry = _u((2, 64, tcfg.d_model), 6)
    _, n_heads, p_hd, n = TMB.mamba_dims(tcfg)
    rh = _u((2, n_heads, p_hd, n), 7)

    def jloss(p, x):
        y, st = JMB.mamba_fwd(jcfg, p, x)
        return jnp.mean(y * ry) + jnp.mean(st["h"] * rh)
    jgp, jgu = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    core.requires_grad_(True)
    ut = torch.from_numpy(u).requires_grad_(True)
    y, st = TMB.mamba_fwd(tcfg, core, ut)
    loss = (y * torch.from_numpy(ry)).mean() \
        + (st["h"] * torch.from_numpy(rh)).mean()
    named = dict(core.named_parameters())
    grads = torch.autograd.grad(loss, [ut, *named.values()])
    if overflow:
        # the upper triangle's largest log-decay, cum_0 - cum_31 of a
        # chunk, is past log(f32 max) = 88.7: exp would overflow there
        da = TMB._proj(tcfg, core, ut.detach())[-1]
        cum = torch.cumsum(da[:, :tcfg.ssm.chunk], 1)
        assert (cum[:, 0] - cum[:, -1]).max() > 88.8
    for g in grads:
        assert torch.isfinite(g).all()
    _close(grads[0], jgu, 1e-4, "du")
    for (name, _), g in zip(named.items(), grads[1:]):
        _close(g, jgp[name], 1e-4, name)


# ---------------------------------------------------------------------------
# hybrid decode with the ApproxFFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route_scope", ["layer", "tick"])
def test_hybrid_decode_collects_dispatch_metrics(route_scope):
    """Four decode ticks with slot 1 idle: the port's metrics carry
    ``invocation`` and ``class_counts`` summing to the active rows and
    equal to the reference's counts; ``pallas`` (its plain twin here)
    within 3e-5 of the reference's ``xla`` oracle and bitwise equal to
    ``pallas_fused``; every slot's ``pos`` advances, as in the
    reference."""
    jcfg, tcfg = _cfgs(approx=True, route_scope=route_scope)
    jp, tp = models(jcfg, tcfg, seed=8)
    assert hasattr(tp, "tick_router")
    b = 3
    mask = np.array([True, False, True])
    jcache = JM.init_cache(jcfg, b, 32)
    tcaches = {be: TM.init_cache(tcfg, b, 32, device="cpu")
               for be in ("pallas", "pallas_fused")}
    steps = {be: TS.make_decode_step(tcfg, use_mcma_dispatch=True,
                                     with_stats=True, backend=be)
             for be in tcaches}
    toks = np.arange(1, b + 1, dtype=np.int32)[:, None]
    for tick in range(4):
        jl, jcache, jm = JM.decode(jcfg, jp, jcache, jnp.asarray(toks),
                                   serve=True, collect_metrics=True,
                                   row_mask=jnp.asarray(mask))
        out = {be: steps[be](tp, tcaches[be], torch.from_numpy(toks),
                             torch.from_numpy(mask)) for be in steps}
        tl, _, tm = out["pallas"]
        assert "invocation" in tm and "class_counts" in tm, sorted(tm)
        assert int(tm["class_counts"].sum()) == mask.sum()
        np.testing.assert_array_equal(tm["class_counts"].numpy(),
                                      np.asarray(jm["class_counts"]))
        _close(tm["invocation"], jm["invocation"], 1e-6, "invocation")
        _close(tl, jl, 3e-5, f"logits tick {tick}")
        assert torch.equal(tl, out["pallas_fused"][0]), tick
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for be, c in tcaches.items():
        assert c["pos"].tolist() == [4] * b == \
            np.asarray(jcache["pos"]).tolist(), be
        _close(c["mamba"]["h"], jcache["mamba"]["h"], 3e-5, "mamba state")
        _close(c["k"], jcache["k"], 3e-5, "k")


# ---------------------------------------------------------------------------
# DecodeServer
# ---------------------------------------------------------------------------

def _serve(cls, req_cls, opts_cls, cfg, params, prompts, max_new=5, **kw):
    base = dict(batch=3, max_len=64, admission="fifo",
                use_mcma_dispatch=True, route_scope="tick",
                prefill_chunk=8)
    srv = cls(cfg, params, options=opts_cls(**{**base, **kw}))
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    return srv, reqs, srv.run_until_drained(2000)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_hybrid_server_matches_jax(backend):
    """Five requests through three slots at tick scope: the requested
    prefill chunk falls back to token by token (no prefill tick), and
    greedy tokens, TTFT ticks and drain counters equal the reference's
    server on the same converted parameters and prompts."""
    jcfg, tcfg = _cfgs(approx=True)
    jp, tp = models(jcfg, tcfg, seed=9)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, tcfg.vocab, n).astype(np.int32)
               for n in (4, 9, 2, 6, 3)]
    js, jreqs, jst = _serve(JServer, JRequest, JOptions, jcfg, jp, prompts,
                            backend="xla")
    ts, treqs, tst = _serve(DecodeServer, Request, ServeOptions, tcfg, tp,
                            prompts, backend=backend)
    assert ts.prefill_chunk == 0 and tst["prefill_ticks"] == 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and not tr.aborted
        assert tr.out == jr.out, (tr.rid, tr.out, jr.out)
        assert (tr.arrival_tick, tr.first_token_tick) == \
            (jr.arrival_tick, jr.first_token_tick)
    for k in ("ticks", "prefill_ticks", "kv_bytes_resident",
              "routed_per_class", "dispatched_per_class", "dropped_rows",
              "undrained_queued", "undrained_inflight"):
        assert tst[k] == jst[k], (k, tst[k], jst[k])
    assert abs(tst["invocation_rate"] - jst["invocation_rate"]) <= 1e-6
    assert [(p, n) for p, n, _ in ts.tick_log] == \
        [(p, n) for p, n, _ in js.tick_log]


@pytest.mark.parametrize("arch", ["olmo-1b", ARCH])
def test_server_slot_reset_isolates_requests(arch):
    """tests/test_runtime.py's case on the port: the same prompt gives the
    same tokens in a fresh server and in a recycled slot (olmo's KV
    cache; the hybrid's Mamba2 states and per-group KV cache)."""
    cfg = smoke_config(get_config(arch))
    params = TM.init_model(0, cfg, device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    opts = ServeOptions(batch=1, max_len=64)
    fresh = DecodeServer(cfg, params, options=opts)
    r1 = Request(rid=0, prompt=prompt, max_new=5)
    fresh.submit(r1)
    fresh.run_until_drained(200)
    recycled = DecodeServer(cfg, params, options=opts)
    filler = Request(rid=1, prompt=np.ones(3, np.int32), max_new=4)
    r2 = Request(rid=2, prompt=prompt, max_new=5)
    recycled.submit(filler)
    recycled.submit(r2)
    recycled.run_until_drained(200)
    assert filler.done and len(r1.out) == 5
    assert r1.out == r2.out, (r1.out, r2.out)


def test_launcher_serves_the_hybrid_and_refuses_embedding_inputs():
    stats = launch_serve.main(["--arch", ARCH, "--smoke", "--approx",
                               "--mcma-dispatch", "--route-scope", "tick",
                               "--device", "cpu", "--requests", "3",
                               "--max-new", "4", "--batch", "2"])
    assert stats["ticks"] > 0 and stats["prefill_ticks"] == 0
    assert 0.0 <= stats["invocation_rate"] <= 1.0
    with pytest.raises(ValueError, match="embeddings"):
        launch_serve.main(["--arch", "musicgen-large", "--smoke",
                           "--device", "cpu"])
