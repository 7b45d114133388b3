"""The PyTorch port's paged KV cache against the JAX reference and its own
dense cache, on the smoke internlm2 config (ApproxFFN on, float32).

Against the reference: the ``init_cache`` layout (the port's pools carry
one trash page past the reference's extent, which is all that is
compared), ``reset_slot``, ``_gather_pages``, chunked prefill then decode
at prompt lengths straddling the page size (pools and ``pos``), and the
reference's ``mode="drop"`` writes.  Within the port: paged == dense
tokens and stats, a constrained pool defers admission but serves
everything, pool overflow raises at submit, a never-fits request injected
into the queue is aborted at admission, and pages come back on finish,
abort and strand.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
P = 8                                   # page size


def _cfgs():
    """No-clip capacities, as the reference's paged tests: the batch mix a
    deferral changes then decides no row's path."""
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, exact_frac=1.0, invoke_frac=1.0))
    return (enable(jsmoke(jget_config("internlm2-1.8b"))),
            enable(smoke_config(get_config("internlm2-1.8b"))))


_PARAMS = {}


def _models():
    jcfg, tcfg = _cfgs()
    if not _PARAMS:
        jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
        _PARAMS["j"] = jp
        _PARAMS["t"] = params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, _PARAMS["j"], _PARAMS["t"]


def _boundary_prompts(seed=0):
    """Prompt lengths straddling the page size: P-1, P, P+1, 2P+1, plus
    fillers so slots churn through alloc/free cycles."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32)
            for n in (P - 1, P, P + 1, 2 * P + 1, 3, 25, 12, 31, 5)]


def _serve(cfg, params, prompts, max_new=6, **kw):
    base = dict(batch=4, max_len=64, admission="fifo")
    base.update(kw)
    srv = DecodeServer(cfg, params, options=ServeOptions(**base))
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    return srv, reqs, srv.run_until_drained(2000)


def test_init_cache_paged_layout_matches_jax():
    jcfg, tcfg, _, _ = _models()
    j = JM.init_cache(jcfg, 4, 64, page_size=P, kv_pages=10)
    t = TM.init_cache(tcfg, 4, 64, page_size=P, kv_pages=10, device="cpu")
    assert set(t) == set(j) == {"k", "v", "block_table", "pos"}
    for key in ("k", "v"):
        assert t[key].shape == (tcfg.n_layers, 11, P, tcfg.n_kv_heads,
                                tcfg.hd)           # 10 pages + the trash
        np.testing.assert_array_equal(t[key][:, :10].numpy(),
                                      np.asarray(j[key]))
    for key in ("block_table", "pos"):
        assert t[key].dtype == torch.int32
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))
    with pytest.raises(AssertionError):
        TM.init_cache(tcfg, 4, 64, page_size=7, kv_pages=10, device="cpu")


def test_reset_slot_clears_block_table_row_and_pos_only():
    jcfg, tcfg, _, _ = _models()
    bt = np.asarray([[0, 1, -1, -1], [2, 3, 4, -1], [5, -1, -1, -1]],
                    np.int32)
    j = dict(JM.init_cache(jcfg, 3, 32, page_size=P, kv_pages=6))
    j["block_table"], j["k"] = jnp.asarray(bt), j["k"] + 1.0
    j["pos"] = jnp.asarray([5, 17, 3], jnp.int32)
    t = TM.init_cache(tcfg, 3, 32, page_size=P, kv_pages=6, device="cpu")
    t["block_table"].copy_(torch.from_numpy(bt))
    t["k"] += 1.0
    t["pos"].copy_(torch.tensor([5, 17, 3]))
    k_before = t["k"].clone()
    j2 = JM.reset_slot(jcfg, j, JM.init_cache(jcfg, 3, 32, page_size=P,
                                              kv_pages=6), 1)
    t2 = TM.reset_slot(tcfg, t, TM.init_cache(tcfg, 3, 32, page_size=P,
                                              kv_pages=6, device="cpu"), 1)
    for key in ("block_table", "pos"):
        np.testing.assert_array_equal(t2[key].numpy(), np.asarray(j2[key]))
    assert t2["block_table"][1].tolist() == [-1] * 4
    assert t2["pos"].tolist() == [5, 0, 3]
    assert torch.equal(t2["k"], k_before)          # shared pools untouched
    np.testing.assert_array_equal(t2["k"][:, :6].numpy(),
                                  np.asarray(j2["k"]))


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(6, 4, 2, 3)).astype(np.float32)
    bt = np.asarray([[3, 0, -1], [5, -1, -1], [-1, -1, -1]], np.int32)
    want = np.asarray(JL._gather_pages(jnp.asarray(pool), jnp.asarray(bt)))
    got = TL._gather_pages(torch.from_numpy(pool), torch.from_numpy(bt))
    assert got.shape == (3, 12, 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [P - 1, P, P + 1, 2 * P + 1])
def test_paged_prefill_and_decode_match_jax(n):
    """A prompt of n tokens chunked in 8s into pages 5, 2, 9 of slot 1 (slot
    0 idle, no pages), then 3 decode ticks: the pools (reference extent),
    the block table, ``pos`` and the logits match the reference's."""
    jcfg, tcfg, jparams, tparams = _models()
    kw = dict(use_mcma_dispatch=True, with_stats=True, backend="pallas")
    b, max_len, pages = 2, 32, 10
    jcache = JM.init_cache(jcfg, b, max_len, page_size=P, kv_pages=pages)
    tcache = TM.init_cache(tcfg, b, max_len, page_size=P, kv_pages=pages,
                           device="cpu")
    bt = np.full((b, max_len // P), -1, np.int32)
    bt[1, :3] = [5, 2, 9]
    jcache = dict(jcache, block_table=jnp.asarray(bt))
    tcache["block_table"].copy_(torch.from_numpy(bt))
    prompt = np.random.default_rng(n).integers(1, 512, n).astype(np.int32)
    mask = np.asarray([False, True])
    jchunk = JS.make_prefill_chunk_step(jcfg, **kw)
    tchunk = TS.make_prefill_chunk_step(tcfg, **kw)
    for c0 in range(0, n - 1, 8):
        piece = np.zeros((b, 8), np.int32)
        nv = np.asarray([0, min(8, n - 1 - c0)], np.int32)
        piece[1, :nv[1]] = prompt[c0:c0 + nv[1]]
        jcache, _ = jchunk(jparams, jcache, jnp.asarray(piece),
                           jnp.asarray(nv), jnp.asarray(mask))
        tcache, _ = tchunk(tparams, tcache, torch.from_numpy(piece),
                           torch.from_numpy(nv), torch.from_numpy(mask))
    jdec = JS.make_decode_step(jcfg, **kw)
    tdec = TS.make_decode_step(tcfg, **kw)
    tok = np.asarray([[0], [prompt[-1]]], np.int32)
    for _ in range(3):
        jl, jcache, _ = jdec(jparams, jcache, jnp.asarray(tok),
                             jnp.asarray(mask))
        tl, tcache, _ = tdec(tparams, tcache, torch.from_numpy(tok),
                             torch.from_numpy(mask))
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1], **TOL)
        tok = np.asarray([[0], [int(np.argmax(np.asarray(jl)[1]))]],
                         np.int32)
        assert int(tl[1].argmax()) == tok[1, 0]
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() \
        == [0, n + 2]
    np.testing.assert_array_equal(tcache["block_table"].numpy(), bt)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :pages].numpy(),
                                   np.asarray(jcache[key]), **TOL)
        live = tcache[key][:, [5, 2, 9]].reshape(tcfg.n_layers, -1,
                                                 tcfg.n_kv_heads, tcfg.hd)
        assert live[:, :n + 2].abs().sum(-1).gt(0).all()
        assert not live[:, n + 2:].any()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_drop_writes_change_nothing_live(paged):
    """The reference's mode="drop" writes: padded chunk tokens, positions
    past the block table or the cache end, and -1 entries write nothing
    (on a paged pool they land on the trash page alone); the live extent
    equals the reference's after the same chunk."""
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.default_rng(4)
    b, s, max_len = 3, 8, 16
    # slot 0: pos 12, 8 valid tokens -> 4 past the end; slot 1: 3 valid,
    # 5 padded; slot 2: a -1 block-table entry (paged) / pos 0 (dense)
    pos = np.asarray([12, 2, 0], np.int32)
    nv = np.asarray([8, 3, 8], np.int32)
    bt = np.asarray([[0, 1], [2, -1], [-1, -1]], np.int32)
    q = rng.normal(size=(b, s, tcfg.n_heads, tcfg.hd)).astype(np.float32)
    k = rng.normal(size=(b, s, tcfg.n_kv_heads, tcfg.hd)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    if paged:
        shape = (4, P, tcfg.n_kv_heads, tcfg.hd)
        pools = [rng.normal(size=shape).astype(np.float32) for _ in "kv"]
        extra = {"block_table": bt}
    else:
        shape = (b, max_len, tcfg.n_kv_heads, tcfg.hd)
        pools = [rng.normal(size=shape).astype(np.float32) for _ in "kv"]
        extra = {}
    jc = {"k": jnp.asarray(pools[0]), "v": jnp.asarray(pools[1]),
          "pos": jnp.asarray(pos), "n_valid": jnp.asarray(nv),
          **{kk: jnp.asarray(vv) for kk, vv in extra.items()}}
    trash = [np.zeros((1,) + shape[1:], np.float32)] if paged else []
    tc = {"k": torch.from_numpy(np.concatenate([pools[0]] + trash)),
          "v": torch.from_numpy(np.concatenate([pools[1]] + trash)),
          "pos": torch.from_numpy(pos), "n_valid": torch.from_numpy(nv),
          **{kk: torch.from_numpy(vv) for kk, vv in extra.items()}}
    jo, jnew = JL._attention_chunk(jcfg, jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jc)
    to, tnew = TL._attention_chunk(tcfg, torch.from_numpy(q),
                                   torch.from_numpy(k), torch.from_numpy(v),
                                   tc)
    n = shape[0]
    for key in ("k", "v"):
        np.testing.assert_array_equal(tnew[key][:n].numpy(),
                                      np.asarray(jnew[key]))
    np.testing.assert_array_equal(tnew["pos"].numpy(),
                                  np.asarray(jnew["pos"]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    if paged:
        # nothing of slot 2 (no pages) nor slot 0 past page 1 went live
        assert tnew["k"][n].any()                  # the trash page took them
        np.testing.assert_array_equal(tnew["k"][3].numpy(), pools[0][3])
    else:
        np.testing.assert_array_equal(tnew["k"][1, 5:].numpy(),
                                      pools[0][1, 5:])


def test_paged_matches_dense_tokens_and_stats():
    """Tick scope, chunked and token-by-token prefill, two page sizes:
    the dense cache's tokens and dispatch stats, every page returned."""
    _, tcfg, _, tparams = _models()
    kw = dict(use_mcma_dispatch=True, route_scope="tick", backend="pallas")
    for chunk in (0, 8):
        _, a, st_d = _serve(tcfg, tparams, _boundary_prompts(),
                            prefill_chunk=chunk, **kw)
        for page in (8, 16):
            srv, b, st_p = _serve(tcfg, tparams, _boundary_prompts(),
                                  prefill_chunk=chunk, kv_page_size=page,
                                  **kw)
            assert all(r.done and not r.aborted for r in a + b)
            assert [r.out for r in a] == [r.out for r in b], (chunk, page)
            for key in ("invocation_rate", "routed_per_class",
                        "dispatched_per_class", "ticks", "prefill_ticks"):
                assert st_d[key] == st_p[key], (key, chunk, page)
            assert st_p["pages_in_use"] == 0 and st_p["page_hwm"] > 0
            assert sorted(srv._free_pages) == list(range(srv.n_pages))
            assert st_p["kv_bytes_resident"] < st_d["kv_bytes_resident"]


def test_constrained_pool_defers_admission_but_serves_all():
    _, tcfg, _, tparams = _models()
    _, a, _ = _serve(tcfg, tparams, _boundary_prompts(), prefill_chunk=8)
    srv, b, st = _serve(tcfg, tparams, _boundary_prompts(), prefill_chunk=8,
                        kv_page_size=P, kv_pages=12)
    assert all(r.done and not r.aborted for r in b)
    assert [r.out for r in a] == [r.out for r in b]
    assert st["alloc_failures"] > 0
    assert st["page_hwm"] <= 12 and st["pages_in_use"] == 0
    assert sorted(srv._free_pages) == list(range(srv.n_pages))


def test_pool_overflow_rejected_at_submit():
    _, tcfg, _, tparams = _models()
    srv = DecodeServer(tcfg, tparams, options=ServeOptions(
        batch=2, max_len=64, prefill_chunk=8, kv_page_size=8, kv_pages=4))
    # needs ceil((30 + 6) / 8) = 5 pages of a pool of 4
    with pytest.raises(ValueError, match="KV pages"):
        srv.submit(Request(rid=0, prompt=np.ones(30, np.int32), max_new=6))
    assert not srv.queue
    r = Request(rid=1, prompt=np.ones(26, np.int32), max_new=6)  # 4 pages
    srv.submit(r)
    st = srv.run_until_drained(500)
    assert r.done and len(r.out) == 6 and st["pages_in_use"] == 0


def test_injected_never_fits_request_aborted_at_admit():
    _, tcfg, _, tparams = _models()
    srv = DecodeServer(tcfg, tparams, options=ServeOptions(
        batch=1, max_len=64, prefill_chunk=8, kv_page_size=8, kv_pages=4))
    bad = Request(rid=0, prompt=np.ones(30, np.int32), max_new=6)
    good = Request(rid=1, prompt=np.ones(5, np.int32), max_new=4)
    srv.queue.append(bad)                    # straight past validation
    srv.submit(good)
    st = srv.run_until_drained(500)
    assert bad.aborted and not bad.out
    assert good.done and len(good.out) == 4
    assert st["pages_in_use"] == 0
    assert st["undrained_queued"] == st["undrained_inflight"] == 0


def test_pages_released_on_finish_abort_and_strand():
    _, tcfg, _, tparams = _models()
    kw = dict(batch=1, max_len=32, prefill_chunk=0, kv_page_size=8)
    # finish
    srv = DecodeServer(tcfg, tparams, options=ServeOptions(**kw))
    srv.submit(Request(rid=0, prompt=np.ones(9, np.int32), max_new=3))
    srv.tick()
    assert srv.pages_in_use == 1 and srv._bt[0, 0] >= 0
    st = srv.run_until_drained(500)
    assert st["pages_in_use"] == 0 and st["page_hwm"] == 2
    assert (srv._bt == -1).all()
    # abort after admission: the prompt fits the pool but not max_len
    srv = DecodeServer(tcfg, tparams, options=ServeOptions(**kw))
    bad = Request(rid=0, prompt=np.ones(40, np.int32), max_new=4)
    good = Request(rid=1, prompt=np.ones(5, np.int32), max_new=4)
    srv.queue.append(bad)
    srv.submit(good)
    st = srv.run_until_drained(500)
    assert bad.aborted and good.done
    assert st["pages_in_use"] == 0
    assert sorted(srv._free_pages) == list(range(srv.n_pages))
    # stranded at max_ticks
    srv = DecodeServer(tcfg, tparams, options=ServeOptions(**kw))
    r = Request(rid=0, prompt=np.ones(10, np.int32), max_new=20)
    srv.submit(r)
    st = srv.run_until_drained(3)
    assert r.aborted and not r.done and st["undrained_inflight"] == 1
    assert st["pages_in_use"] == 0
    assert sorted(srv._free_pages) == list(range(srv.n_pages))
