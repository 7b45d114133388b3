"""The PyTorch port of every ported architecture against the JAX
reference: tests/test_archs.py on the port, on the smoke configs
(float32), from JAX-initialized parameters converted into the port.

Before conversion every leaf that the reference initializes to a
constant (norm scales and biases, qkv biases, and Mamba2's ``dt_bias``,
``a_log``, ``d_skip`` and ``norm_scale``) gets seeded noise, and both
packages run the perturbed tree, so a leaf the port forgot to apply
cannot hide behind its initial value.

Held: the forward's logits within 3e-5; ``lm_loss`` and every gradient
within 1e-4; after one SGD step of 0.01 the port's logits finite;
prefill -> ``pad_cache`` -> ``decode`` against ``forward`` at position S
within 2e-3 in the port (the reference's own check), the port's decode
logits within 3e-5 of the reference's and ``pos`` exactly.  The same for
``parallel_block``, tied embeddings and gelu / relu FFNs set on the
olmo-1b smoke config in both packages; stablelm-1.6b through the
scheduler (tick scope, chunked prefill, paged cache) with tokens, tick
log and drain counters equal to the reference's server; olmo-1b's and
zamba2's train states across the two packages' checkpoints.  The MoE
family: the prefill + decode check with the reference's no-drop
capacity; mixtral-8x7b's ring buffer decoded 40 steps past its window
(logits 3e-5, ``pos`` exactly); both MoE archs through the reference's
server (moonshot chunked on a dense and a paged cache, mixtral token by
token past the window) with equal tokens and drain counters; a paged
cache refused on a ring buffer, as the reference refuses it.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch import checkpoint as C  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          smoke_config)
from repro_torch.convert import (_split, decay_mask,  # noqa: E402
                                 params_from_jax, train_state_from_jax,
                                 train_state_to_tree)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

B, S = 2, 64
# the leaves the reference initializes to constants
CONST_LEAVES = {"scale", "bias", "bq", "bk", "bv", "dt_bias", "a_log",
                "d_skip", "norm_scale"}
VARIANTS = {"parallel_block": dict(parallel_block=True),
            "tie_embeddings": dict(tie_embeddings=True),
            "gelu": dict(act="gelu", gated_ffn=False),
            "relu": dict(act="relu", gated_ffn=True)}


def _cfgs(arch, **over):
    return (dataclasses.replace(jsmoke(jget_config(arch)), **over),
            dataclasses.replace(smoke_config(get_config(arch)), **over))


def perturb(tree, seed):
    """Seeded noise (0.1 standard normal) on every constant-initialized
    leaf of a reference pytree of numpy arrays; other leaves as they
    are."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                 if k in CONST_LEAVES else v)
                for k, v in t.items()}
    return walk(tree)


def models(jcfg, tcfg, seed=0):
    """(reference params as jnp, the port's Model), from one perturbed
    tree."""
    tree = perturb(jax.tree.map(np.asarray,
                                JM.init_model(jax.random.PRNGKey(seed),
                                              jcfg)), seed + 1)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tcfg, tree, device="cpu"))


def inputs(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return (rng.standard_normal((b, s, cfg.d_model)) * 0.1) \
            .astype(np.float32)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _forward_and_grads(jcfg, tcfg):
    jp, tp = models(jcfg, tcfg)
    x = inputs(tcfg, 1)
    labels = np.random.default_rng(2).integers(0, tcfg.vocab, (B, S)) \
        .astype(np.int32)
    jl, _, _, _ = JM.forward(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        tl, _, _, _ = TM.forward(tcfg, tp, torch.from_numpy(x))
    assert tl.shape == (B, S, tcfg.vocab)
    _close(tl, jl, 3e-5, "logits")

    (jloss, _), jg = jax.value_and_grad(
        lambda p: JM.lm_loss(jcfg, p, jnp.asarray(x), jnp.asarray(labels)),
        has_aux=True)(jp)
    tp.requires_grad_(True)
    named = dict(tp.named_parameters())
    tloss, _ = TM.lm_loss(tcfg, tp, torch.from_numpy(x),
                          torch.from_numpy(labels))
    tg = torch.autograd.grad(tloss, list(named.values()), allow_unused=True)
    _close(tloss.detach(), jloss, 1e-4, "lm_loss")
    want = _split(tcfg, jax.tree.map(np.asarray, jg))
    assert want.keys() == named.keys()
    for (name, p), g in zip(named.items(), tg):
        g = torch.zeros_like(p) if g is None else g
        _close(g, want[name], 1e-4, name)
    # a plain SGD step keeps the port finite
    with torch.no_grad():
        for p, g in zip(named.values(), tg):
            if g is not None:
                p.sub_(0.01 * g)
        tl2, _, _, _ = TM.forward(tcfg, tp, torch.from_numpy(x))
    assert torch.isfinite(tl2).all()


def _prefill_decode(jcfg, tcfg):
    """decode(prefill(x[:S]), x[S]) against forward(x[:2S])[S] (chunked
    scans need chunk-aligned lengths; causality hides the tail), in the
    port and against the reference's decode."""
    jp, tp = models(jcfg, tcfg, seed=3)
    full = inputs(tcfg, 4, B, 2 * S)
    prefix, last = full[:, :S], full[:, S:S + 1]
    with torch.no_grad():
        ref_logits, _, _, _ = TM.forward(tcfg, tp, torch.from_numpy(full))
        _, cache, _, _ = TM.forward(tcfg, tp, torch.from_numpy(prefix),
                                    collect_cache=True)
        cache = TM.pad_cache(tcfg, cache, S + 1)
        got, cache = TM.decode(tcfg, tp, cache, torch.from_numpy(last),
                               serve=False)
    _close(got, ref_logits[:, S], 2e-3, "port decode vs port forward")
    assert cache["pos"].tolist() == [S + 1] * B
    _, jcache, _, _ = JM.forward(jcfg, jp, jnp.asarray(prefix),
                                 collect_cache=True)
    jcache = JM.pad_cache(jcfg, jcache, S + 1)
    jgot, jcache = JM.decode(jcfg, jp, jcache, jnp.asarray(last),
                             serve=False)
    _close(got, jgot, 3e-5, "decode logits vs the reference")
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_grads_match_jax(arch):
    _forward_and_grads(*_cfgs(arch))


def _no_drop(cfg):
    """The reference's override for its decode check (tests/test_archs.py):
    capacity drops depend on how many tokens compete for an expert, which
    differs between a full forward and a one-token decode, so every token
    gets a slot."""
    if not cfg.moe.n_experts:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts) / cfg.moe.top_k))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_forward_and_jax(arch):
    _prefill_decode(*map(_no_drop, _cfgs(arch)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_layer_variants_match_jax(variant):
    """parallel_block, tied embeddings, a tanh-gelu non-gated FFN and a
    relu FFN on olmo-1b's smoke config."""
    jcfg, tcfg = _cfgs("olmo-1b", **VARIANTS[variant])
    _forward_and_grads(jcfg, tcfg)
    _prefill_decode(jcfg, tcfg)


def test_conversion_is_total_for_every_arch():
    """Every reference leaf lands on one parameter of the same shape
    (stacked leaves split per layer or per group and block), olmo's
    parameterless norms carry nothing, and the hybrid's shared block
    stays unstacked."""
    for arch in ARCH_IDS:
        jcfg, tcfg = _cfgs(arch)
        tree = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(0),
                                                      jcfg))
        own = dict(params_from_jax(tcfg, tree, device="cpu")
                   .named_parameters())
        assert own.keys() == _split(tcfg, tree).keys(), arch
    olmo = smoke_config(get_config("olmo-1b"))
    names = dict(TM.init_model(0, olmo, device="cpu").named_parameters())
    assert not [n for n in names if ".ln" in n or n.startswith("ln_f")]
    zcfg = smoke_config(get_config("zamba2-2.7b"))
    zn = dict(TM.init_model(0, zcfg, device="cpu").named_parameters())
    assert "shared.attn.wq" in zn and "mamba.1.1.core.w_xz" in zn
    mask = decay_mask(zcfg, TM.init_model(0, zcfg, device="cpu"))
    # the reference's rank rule on its stacked layout: the shared block's
    # 1-D leaves and ln_f are exempt, every Mamba2 leaf is decayed
    assert not mask["shared.ln1.scale"] and not mask["ln_f.scale"]
    assert mask["mamba.0.0.core.dt_bias"] and mask["shared.attn.wq"]
    # the MoE takes the FFN's place, the ApproxFFN's too, and no
    # tick-router head is built; every MoE leaf is decayed
    mcfg = smoke_config(get_config("moonshot-v1-16b-a3b"))
    mcfg = dataclasses.replace(mcfg, approx=dataclasses.replace(
        mcfg.approx, enable=True))
    mp = TM.init_model(0, mcfg, device="cpu")
    mn = dict(mp.named_parameters())
    assert {"blocks.1.moe.router", "blocks.1.moe.w_in", "blocks.1.moe.w_gate",
            "blocks.1.moe.w_out"} <= mn.keys()
    assert not [n for n in mn if "approx" in n or "tick_router" in n
                or ".ffn." in n]
    mask = decay_mask(mcfg, mp)
    assert all(mask[n] for n in mn if ".moe." in n)


def test_windowed_paged_cache_raises_as_the_reference():
    """A ring buffer has no absolute positions: both packages refuse a
    paged cache, and the port's server a page size, on mixtral-8x7b;
    without pages the cache is a ring of min(max_len, window) rows."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    assert tcfg.sliding_window == jcfg.sliding_window == 32
    with pytest.raises(AssertionError, match="paged KV caches"):
        JM.init_cache(jcfg, 2, 64, page_size=16, kv_pages=8)
    with pytest.raises(AssertionError, match="paged KV caches"):
        TM.init_cache(tcfg, 2, 64, page_size=16, kv_pages=8, device="cpu")
    params = TM.init_model(0, tcfg, device="cpu")
    with pytest.raises(AssertionError, match="paged KV caches"):
        DecodeServer(tcfg, params, options=ServeOptions(
            batch=2, max_len=64, kv_page_size=16))
    for max_len in (16, 64):
        got = TM.init_cache(tcfg, 2, max_len, device="cpu")["k"].shape
        assert got == JM.init_cache(jcfg, 2, max_len)["k"].shape
        assert got[2] == min(max_len, 32)


def test_ring_buffer_decode_past_the_window_matches_jax():
    """mixtral-8x7b's smoke config (window 32): a prefill of 64 keeps the
    last 32 positions, then 40 decode steps wrap the ring past the
    window; each step's logits within 3e-5 of the reference's decode and
    ``pos`` exactly, the ring within 3e-5 of the reference's."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    jp, tp = models(jcfg, tcfg, seed=7)
    toks = inputs(tcfg, 8, B, S + 40)
    with torch.no_grad():
        _, cache, _, _ = TM.forward(tcfg, tp, torch.from_numpy(toks[:, :S]),
                                    collect_cache=True)
    _, jcache, _, _ = JM.forward(jcfg, jp, jnp.asarray(toks[:, :S]),
                                 collect_cache=True)
    assert cache["k"].shape[2] == 32
    cache = TM.pad_cache(tcfg, cache, S + 40)          # a ring: no-op
    assert cache["k"].shape[2] == 32
    jdecode = jax.jit(lambda c, x: JM.decode(jcfg, jp, c, x, serve=False))
    for i in range(40):
        step = toks[:, S + i:S + i + 1]
        with torch.no_grad():
            got, cache = TM.decode(tcfg, tp, cache, torch.from_numpy(step),
                                   serve=False)
        want, jcache = jdecode(jcache, jnp.asarray(step))
        _close(got, want, 3e-5, f"decode step {i}")
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert cache["pos"].tolist() == [S + 40] * B
    _close(cache["k"], jcache["k"], 3e-5, "ring k")


# ---------------------------------------------------------------------------
# stablelm-1.6b through the scheduler
# ---------------------------------------------------------------------------

SCHED = dict(batch=4, max_len=64, admission="fifo", use_mcma_dispatch=True,
             route_scope="tick", prefill_chunk=4, kv_page_size=4)


def _serve(cls, req_cls, opts_cls, cfg, params, prompts, **kw):
    srv = cls(cfg, params, options=opts_cls(**{**SCHED, **kw}))
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    return srv, reqs, srv.run_until_drained(2000)


def test_stablelm_scheduler_matches_jax():
    """stablelm-1.6b (LayerNorm with bias, qkv biases, 25 % rotary) with
    the ApproxFFN at tick scope, chunk 4, page 4: tokens, TTFT ticks,
    drain counters and the tick log equal to the reference's server; in
    the port the dense cache and the fused kernel's plain twin give the
    same bits."""
    jcfg, tcfg = _cfgs("stablelm-1.6b")
    jcfg, tcfg = (dataclasses.replace(c, approx=dataclasses.replace(
        c.approx, enable=True)) for c in (jcfg, tcfg))
    jp, tp = models(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, tcfg.vocab, n).astype(np.int32)
               for n in (3, 9, 14, 5, 11, 6)]
    js, jreqs, jst = _serve(JServer, JRequest, JOptions, jcfg, jp, prompts)
    ts, treqs, tst = _serve(DecodeServer, Request, ServeOptions, tcfg, tp,
                            prompts)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and not tr.aborted
        assert tr.out == jr.out, (tr.rid, tr.out, jr.out)
        assert (tr.arrival_tick, tr.first_token_tick) == \
            (jr.arrival_tick, jr.first_token_tick)
    for k in ("ticks", "prefill_ticks", "prefill_tokens", "pages_in_use",
              "page_hwm", "alloc_failures", "kv_bytes_resident",
              "routed_per_class", "dispatched_per_class", "dropped_rows",
              "undrained_queued", "undrained_inflight"):
        assert tst[k] == jst[k], (k, tst[k], jst[k])
    for k in ("invocation_rate", "prefill_invocation_rate", "page_util"):
        assert abs(tst[k] - jst[k]) <= 1e-6, (k, tst[k], jst[k])
    assert tst["prefill_ticks"] > 0
    assert [(p, n) for p, n, _ in ts.tick_log] == \
        [(p, n) for p, n, _ in js.tick_log]
    for over in (dict(kv_page_size=0), dict(backend="pallas_fused")):
        other, oreqs, _ = _serve(DecodeServer, Request, ServeOptions, tcfg,
                                 tp, prompts, **over)
        assert [r.out for r in oreqs] == [r.out for r in treqs], over
        assert other.tick_log == ts.tick_log, over


# ---------------------------------------------------------------------------
# the MoE family through the server
# ---------------------------------------------------------------------------

MOE_SERVE = {
    # moonshot: chunked prefill; MCMA dispatch on, which serves the MoE
    "moonshot-dense": ("moonshot-v1-16b-a3b", dict(kv_page_size=0)),
    "moonshot-paged": ("moonshot-v1-16b-a3b", dict()),
    # mixtral: the ring buffer feeds prompts token by token; prompt +
    # max_new passes the 32-token window
    "mixtral-ring": ("mixtral-8x7b", dict(
        use_mcma_dispatch=False, kv_page_size=0, prefill_chunk=4)),
}


@pytest.mark.parametrize("case", sorted(MOE_SERVE))
def test_moe_server_matches_jax(case):
    """Each MoE smoke config through both packages' DecodeServer:
    greedy tokens, TTFT ticks, drain counters and the tick log equal to
    the reference's in float32 (idle slots' rows and padded chunk rows
    compete for expert capacity in both)."""
    arch, over = MOE_SERVE[case]
    jcfg, tcfg = (dataclasses.replace(c, approx=dataclasses.replace(
        c.approx, enable=True)) for c in _cfgs(arch))
    jp, tp = models(jcfg, tcfg, seed=9)
    rng = np.random.default_rng(10)
    lens = (3, 9, 14, 25, 6, 21) if tcfg.sliding_window \
        else (3, 9, 14, 5, 11, 6)
    max_new = 12 if tcfg.sliding_window else 5
    prompts = [rng.integers(1, tcfg.vocab, n).astype(np.int32)
               for n in lens]
    kw = dict(over, max_len=64)

    def serve(cls, req_cls, opts_cls, cfg, params):
        srv = cls(cfg, params, options=opts_cls(**{**SCHED, **kw}))
        reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        return srv, reqs, srv.run_until_drained(2000)
    js, jreqs, jst = serve(JServer, JRequest, JOptions, jcfg, jp)
    ts, treqs, tst = serve(DecodeServer, Request, ServeOptions, tcfg, tp)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and not tr.aborted
        assert tr.out == jr.out, (tr.rid, tr.out, jr.out)
        assert (tr.arrival_tick, tr.first_token_tick) == \
            (jr.arrival_tick, jr.first_token_tick)
    for k in ("ticks", "prefill_ticks", "prefill_tokens", "pages_in_use",
              "page_hwm", "alloc_failures", "kv_bytes_resident",
              "invocation_rate", "dropped_rows", "undrained_queued",
              "undrained_inflight"):
        assert tst.get(k) == jst.get(k), (k, tst.get(k), jst.get(k))
    assert [(p, n) for p, n, _ in ts.tick_log] == \
        [(p, n) for p, n, _ in js.tick_log]
    if tcfg.sliding_window:
        assert tst["prefill_ticks"] == 0 and ts.cache["k"].shape[2] == 32
        assert max(len(p) + max_new for p in prompts) > 32
    else:
        assert tst["prefill_ticks"] > 0


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _jax_state(arch):
    jcfg, tcfg = _cfgs(arch)
    jstate = JS.init_train_state(jax.random.PRNGKey(0), jcfg)
    return tcfg, jstate


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-2.7b"])
def test_checkpoints_cross_between_packages(arch, tmp_path):
    """A reference checkpoint reads into the port as train_state_from_jax
    of the same state, and the port's checkpoint reads back through the
    reference's restore as the same pytree, olmo's empty norm dicts and
    the hybrid's unstacked shared block included."""
    from repro import checkpoint as JC
    tcfg, jstate = _jax_state(arch)
    JC.save(str(tmp_path / "ref"), 1, jstate)
    tree, step = C.restore(str(tmp_path / "ref"))
    got = train_state_from_jax(tcfg, tree, device="cpu")
    want = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                device="cpu")
    assert step == 1 and int(got["step"]) == int(want["step"])
    for (n, a), b in zip(got["params"].named_parameters(),
                         want["params"].parameters()):
        assert torch.equal(a, b), n
    C.save(str(tmp_path / "port"), 1, train_state_to_tree(tcfg, want))
    back, _ = JC.restore(str(tmp_path / "port"))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    wl = jax.tree_util.tree_flatten_with_path(jstate)[0]
    gl = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(gl) == len(wl)
    for path, leaf in wl:
        np.testing.assert_array_equal(np.asarray(gl[path]), np.asarray(leaf),
                                      err_msg=str(path))
