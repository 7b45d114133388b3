"""The PyTorch port's chunked prefill, dense forward and scheduler against
the JAX reference, on the smoke internlm2 config (ApproxFFN on, float32,
converted JAX parameters).

Against the reference: ``decode_chunk`` (cache, pos, metrics), one
request stream through both ``DecodeServer``s at tick scope with chunked
prefill and a paged cache (tokens and counters equal), the dense
``forward``.  Within the port: chunked == token-by-token at no-clip
capacities, fused == unfused, and ``forward``'s last logits equal
``decode_chunk`` + ``decode``.  Floats within rtol = atol = 3e-5,
discrete outputs exactly.
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
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
NO_CLIP = dict(exact_frac=1.0, invoke_frac=1.0)


def _cfgs(**over):
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, **over))
    return (enable(jsmoke(jget_config("internlm2-1.8b"))),
            enable(smoke_config(get_config("internlm2-1.8b"))))


_PARAMS = {}


def _models(**over):
    """(jcfg, tcfg, jparams, tparams), the parameters made once per module
    (they do not depend on the capacity fractions)."""
    jcfg, tcfg = _cfgs(**over)
    if not _PARAMS:
        jp = JM.init_model(jax.random.PRNGKey(3), jcfg)
        _PARAMS["j"] = jp
        _PARAMS["t"] = params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, _PARAMS["j"], _PARAMS["t"]


def _prompts(seed=0, lens=(3, 9, 17, 5, 12, 25, 8)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n in lens]


def _serve(cls, req_cls, opts_cls, cfg, params, prompts, max_new=4, **kw):
    base = dict(batch=4, max_len=64, admission="fifo",
                use_mcma_dispatch=True)
    base.update(kw)
    srv = cls(cfg, params, options=opts_cls(**base))
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    return srv, reqs, srv.run_until_drained(2000)


@pytest.mark.parametrize("paged,scope", [(False, "layer"), (True, "tick")],
                         ids=["dense-layer", "paged-tick"])
def test_decode_chunk_matches_jax(paged, scope):
    """Two chunks of up to 8 tokens (ragged n_valid, an idle slot) then a
    decode step: the cache, pos, the chunk metrics and the logits."""
    jcfg, tcfg, jparams, tparams = _models()
    kw = dict(use_mcma_dispatch=True, with_stats=True, route_scope=scope,
              backend="pallas")
    jchunk = JS.make_prefill_chunk_step(jcfg, **kw)
    tchunk = TS.make_prefill_chunk_step(tcfg, **kw)
    b, s, max_len = 4, 8, 32
    ckw = dict(page_size=8, kv_pages=12) if paged else {}
    jcache = JM.init_cache(jcfg, b, max_len, **ckw)
    tcache = TM.init_cache(tcfg, b, max_len, device="cpu", **ckw)
    if paged:
        bt = np.full((b, 4), -1, np.int32)
        bt[0, :2], bt[1, :3], bt[3, :1] = [3, 7], [0, 1, 2], [11]
        jcache = dict(jcache, block_table=jnp.asarray(bt))
        tcache["block_table"].copy_(torch.from_numpy(bt))
    rng = np.random.default_rng(1)
    mask = np.asarray([True, True, False, True])
    for nv in ([8, 8, 5, 3], [6, 8, 0, 2]):
        toks = rng.integers(1, 512, (b, s)).astype(np.int32)
        nv = np.asarray(nv, np.int32)
        jcache, jm = jchunk(jparams, jcache, jnp.asarray(toks),
                            jnp.asarray(nv), jnp.asarray(mask))
        tcache, tm = tchunk(tparams, tcache, torch.from_numpy(toks),
                            torch.from_numpy(nv), torch.from_numpy(mask))
        for k in ("class_counts", "dispatched", "dropped_rows"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=k)
        np.testing.assert_allclose(float(tm["invocation"]),
                                   float(jm["invocation"]), atol=1e-6)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    n = jcache["k"].shape[1]            # the reference's extent
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :n].numpy(),
                                   np.asarray(jcache[key]), **TOL,
                                   err_msg=key)
    jdec = JS.make_decode_step(jcfg, **kw)
    tdec = TS.make_decode_step(tcfg, **kw)
    toks = rng.integers(1, 512, (b, 1)).astype(np.int32)
    jl, jcache, _ = jdec(jparams, jcache, jnp.asarray(toks),
                         jnp.asarray(mask))
    tl, tcache, _ = tdec(tparams, tcache, torch.from_numpy(toks),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               **TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_server_tick_chunked_paged_matches_jax(backend):
    """One request stream, route_scope="tick", prefill_chunk=8,
    kv_page_size=8, fifo admission: equal tokens, TTFT ticks, drain
    counters and tick_log phases."""
    jcfg, tcfg, jparams, tparams = _models()
    kw = dict(route_scope="tick", prefill_chunk=8, kv_page_size=8,
              kv_pages=8, backend=backend)
    js, jreqs, jst = _serve(JServer, JRequest, JOptions, jcfg, jparams,
                            _prompts(), **kw)
    ts, treqs, tst = _serve(DecodeServer, Request, ServeOptions, tcfg,
                            tparams, _prompts(), **kw)
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
    assert tst["alloc_failures"] > 0          # the pool deferred admission
    for k in ("invocation_rate", "prefill_invocation_rate", "page_util"):
        assert abs(tst[k] - jst[k]) <= 1e-6, (k, tst[k], jst[k])
    assert [(p, n) for p, n, _ in ts.tick_log] == \
        [(p, n) for p, n, _ in js.tick_log]


def test_chunked_matches_token_by_token_and_fused_matches_unfused():
    """No-clip capacities: chunked (8) and token-by-token prefill sample
    the same tokens with fewer ticks, on both kernel backends, dense and
    paged; the fused backend's tokens and counters equal the unfused."""
    _, tcfg, _, tparams = _models()
    tcfg = dataclasses.replace(tcfg, approx=dataclasses.replace(
        tcfg.approx, **NO_CLIP))
    runs = {}
    for backend in ("pallas", "pallas_fused"):
        for chunk in (0, 8):
            for page in (0, 8):
                _, reqs, st = _serve(DecodeServer, Request, ServeOptions,
                                     tcfg, tparams, _prompts(),
                                     route_scope="tick", backend=backend,
                                     prefill_chunk=chunk, kv_page_size=page)
                assert all(r.done and not r.aborted for r in reqs)
                runs[backend, chunk, page] = ([r.out for r in reqs], st)
    want = runs["pallas", 0, 0][0]
    for key, (outs, _) in runs.items():
        assert outs == want, key
    for chunk in (0, 8):
        for page in (0, 8):
            a = runs["pallas", chunk, page][1].asdict()
            b = runs["pallas_fused", chunk, page][1].asdict()
            a.pop("wall_s"), b.pop("wall_s")
            assert a == b, (chunk, page)
    assert runs["pallas", 8, 0][1]["prefill_ticks"] > 0
    assert runs["pallas", 8, 0][1]["ticks"] < runs["pallas", 0, 0][1]["ticks"]


def test_chunked_decode_phase_invocations_match_token_by_token():
    """Batch 1 keeps tick rows aligned: the chunked run's decode-tick
    invocation sequence equals the tail of the token run's (the port's
    counterpart of tests/test_serving.py's batch-1 check)."""
    _, tcfg, _, tparams = _models()
    tcfg = dataclasses.replace(tcfg, approx=dataclasses.replace(
        tcfg.approx, **NO_CLIP))
    prompt = np.arange(1, 34, dtype=np.int32)
    outs, logs = [], []
    for chunk in (0, 8):
        srv, reqs, _ = _serve(DecodeServer, Request, ServeOptions, tcfg,
                              tparams, [prompt], max_new=6, batch=1,
                              route_scope="tick", prefill_chunk=chunk)
        outs.append(reqs[0].out)
        logs.append(srv.tick_log)
    assert outs[0] == outs[1]
    dec_token = [inv for ph, _, inv in logs[0] if ph == "decode"]
    dec_chunk = [inv for ph, _, inv in logs[1] if ph == "decode"]
    assert len(dec_chunk) == 6 and len(dec_token) == 32 + 6
    assert dec_token[-6:] == dec_chunk, (dec_token[-6:], dec_chunk)
    assert [n for ph, n, _ in logs[1] if ph == "prefill"] == [8, 8, 8, 8]


def test_dense_forward_matches_jax_and_chunked_decode():
    """The serve-mode dense forward (layer routing, flash attention over
    two q/kv blocks) against the reference; its last logits against
    decode_chunk over the prompt but its last token, then decode; and
    make_prefill_step's cache, padded, against decode_chunk's."""
    jcfg, tcfg, jparams, tparams = _models(**NO_CLIP)
    jcfg_s = JS.mcma_serve_config(jcfg, backend="pallas")
    tcfg_s = TS.mcma_serve_config(tcfg, backend="pallas")
    b, s = 2, 64                       # two 32-blocks of q and kv
    toks = np.random.default_rng(2).integers(1, 512, (b, s)).astype(np.int32)
    jl, _, _, jm = JM.forward(jcfg_s, jparams, jnp.asarray(toks), serve=True)
    with torch.no_grad():
        tl, _, _, tm = TM.forward(tcfg_s, tparams, torch.from_numpy(toks),
                                  serve=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("class_counts", "dispatched"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))

    last, pcache = TS.make_prefill_step(tcfg_s)(
        tparams, {"inputs": torch.from_numpy(toks)})
    np.testing.assert_allclose(last.numpy(), tl[:, -1].numpy(), **TOL)
    assert pcache["pos"].tolist() == [s] * b
    chunk = TS.make_prefill_chunk_step(tcfg, use_mcma_dispatch=True)
    cache = TM.init_cache(tcfg, b, 96, device="cpu")
    nv = torch.full((b,), 32, dtype=torch.int32)
    for c0 in (0, 32):
        piece = torch.from_numpy(toks[:, c0:c0 + 32].copy())
        if c0:
            nv = torch.full((b,), 31, dtype=torch.int32)
        cache, _ = chunk(tparams, cache, piece, nv)
    got, cache = TS.make_decode_step(tcfg, use_mcma_dispatch=True)(
        tparams, cache, torch.from_numpy(toks[:, -1:].copy()))
    np.testing.assert_allclose(got.numpy(), tl[:, -1].numpy(), **TOL)
    assert torch.equal(got.argmax(-1), tl[:, -1].argmax(-1))
    padded = TM.pad_cache(tcfg, pcache, 96)
    assert padded["k"].shape == cache["k"].shape
    np.testing.assert_allclose(padded["k"].numpy(), cache["k"].numpy(),
                               **TOL)
