"""Approximator-library residency in the PyTorch port, against the JAX
reference: the single-device cases of tests/test_library.py rerun on the
port, ``train_library``'s smoke case included.

Both packages get the same numpy inputs and, at the engine level, the
SAME router logits: ``lib_counts``, ``off_set_exact_rows`` and every
count are held exactly, floats within rtol = atol = 3e-5 (float32).  The
ResidencyController is replayed on the same stats sequences in both
packages (equal swaps and trajectories).  Inside the port: identity
residency equals the library-less engine, and the library-less server,
bitwise.  A library checkpoint converts leaf by leaf.
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import autotune as JAT  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime.options import LibrarySpec as JSpec  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.analysis.jit_cache import assert_zero_retrace  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import autotune as AT  # noqa: E402
from repro_torch.runtime import dispatch as TD  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402
from repro_torch.runtime.options import LibrarySpec, ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
RESIDENCIES = ([0, 1], [2, 5], [4, 0], [3, 2])
LIB_KEYS = ("class_counts", "dispatched", "lib_counts", "off_set_exact_rows")


def _library_case(seed, t, lib, d, d_h):
    """Inputs, library-wide router logits and PREPADDED library stacks."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x = f(t, d, sc=0.5)
    logits = x @ f(d, lib + 1, sc=0.5)
    w = [np.array(a) for a in jops.prepad_switched_weights(
        f(lib, d, d_h, sc=0.2), f(lib, d_h, sc=0.1), f(lib, d_h, d, sc=0.2),
        f(lib, d, sc=0.1))]
    return x, logits, w, (f(d, 2 * d, sc=0.1), f(2 * d, d, sc=0.1))


def _both(x, logits, w, ex, backend, residency=None, **kw):
    wi, wo = ex
    jres = None if residency is None else jnp.asarray(residency, jnp.int32)
    tres = None if residency is None else torch.tensor(residency,
                                                       dtype=torch.int32)
    jy, js = JD.mcma_dispatch(
        jnp.asarray(x), jnp.asarray(logits),
        lambda xb: jnp.dot(jax.nn.silu(jnp.dot(xb, wi)), wo),
        *map(jnp.asarray, w), backend=backend, block_t=32,
        interpret=backend != "xla", weights_prepadded=True, residency=jres,
        **kw)
    twi, two = torch.from_numpy(wi), torch.from_numpy(wo)
    ty, ts = TD.mcma_dispatch(
        torch.from_numpy(x), torch.from_numpy(logits),
        lambda xb: F.silu(xb @ twi) @ two, *map(torch.from_numpy, w),
        backend=backend, block_t=32, weights_prepadded=True,
        residency=tres, **kw)
    return ((np.asarray(jy), jax.tree.map(np.asarray, dict(js))),
            (ty.numpy(), {k: v.numpy() for k, v in ts.items()}))


def _assert_equal(j, t, keys=LIB_KEYS):
    np.testing.assert_allclose(t[0], j[0], **TOL)
    for k in keys:
        np.testing.assert_array_equal(t[1][k], j[1][k], err_msg=k)


# ---------------------------------------------------------------------------
# the residency fold: exact off-set accounting
# ---------------------------------------------------------------------------

def test_residency_fold_accounting_exact():
    t, lib = 128, 6
    x, logits, w, ex = _library_case(0, t, lib, 48, 16)
    j, tt = _both(x, logits, w, ex, "xla", [4, 1], exact_cap=t,
                  invoke_cap=t)
    _assert_equal(j, tt)
    s = tt[1]
    assert s["lib_counts"].shape == (lib + 1,)
    assert s["lib_counts"].dtype == np.int32
    assert s["lib_counts"].sum() == t
    for slot, c in enumerate([4, 1]):
        assert s["class_counts"][slot + 1] == s["lib_counts"][c + 1]
    off = sum(s["lib_counts"][c + 1] for c in range(lib) if c not in (4, 1))
    assert s["off_set_exact_rows"] == off
    assert s["class_counts"][0] == s["lib_counts"][0] + off
    _, t0 = _both(x, logits, w, ex, "xla", list(range(lib)), exact_cap=t,
                  invoke_cap=t)
    assert t0[1]["off_set_exact_rows"] == 0


def test_identity_residency_is_library_less_engine():
    t, lib = 96, 4
    x, logits, w, ex = _library_case(1, t, lib, 48, 16)
    kw = dict(exact_cap=t // 2, invoke_cap=max(t // 8, 1))
    _, t0 = _both(x, logits, w, ex, "xla", **kw)
    j1, t1 = _both(x, logits, w, ex, "xla", list(range(lib)), **kw)
    np.testing.assert_array_equal(t0[0], t1[0])
    for k in ("class_counts", "dispatched"):
        np.testing.assert_array_equal(t0[1][k], t1[1][k])
    np.testing.assert_array_equal(t1[1]["lib_counts"],
                                  t1[1]["class_counts"])
    assert int(t1[1]["off_set_exact_rows"]) == 0
    _assert_equal(j1, t1)


def test_residency_backends_match_jax_every_set():
    t, lib = 128, 6
    x, logits, w, ex = _library_case(2, t, lib, 48, 16)
    kw = dict(exact_cap=t // 2, invoke_cap=max(t // 6, 1))
    wi, wo = map(torch.from_numpy, ex)
    for res in RESIDENCIES:
        outs = {}
        for backend in ("xla", "pallas"):
            j, outs[backend] = _both(x, logits, w, ex, backend, res, **kw)
            _assert_equal(j, outs[backend])
        np.testing.assert_allclose(outs["pallas"][0], outs["xla"][0], **TOL,
                                   err_msg=str(res))
        for k in LIB_KEYS:
            np.testing.assert_array_equal(outs["pallas"][1][k],
                                          outs["xla"][1][k], err_msg=k)
        fused, _ = TD.mcma_dispatch(
            torch.from_numpy(x), torch.from_numpy(logits),
            lambda xb: F.silu(xb @ wi) @ wo, *map(torch.from_numpy, w),
            backend="pallas_fused", block_t=32, weights_prepadded=True,
            residency=torch.tensor(res, dtype=torch.int32), **kw)
        np.testing.assert_array_equal(fused.numpy(), outs["pallas"][0],
                                      err_msg=str(res))


def test_gather_resident_stacks_matches_jax():
    _, _, w, _ = _library_case(3, 8, 6, 32, 8)
    for res in RESIDENCIES + ([7, -1],):
        got = tops.gather_resident_stacks(
            *map(torch.from_numpy, w), torch.tensor(res, dtype=torch.int32))
        want = jops.gather_resident_stacks(*map(jnp.asarray, w),
                                           jnp.asarray(res, jnp.int32))
        for g, wv in zip(got, want):
            assert g.shape[0] == len(res) + 1
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# decode path, library checkpoints
# ---------------------------------------------------------------------------

_PARAMS = {}


def _models(library_size=6, **over):
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, library_size=library_size, **over))
    jcfg = enable(jsmoke(jget_config("internlm2-1.8b")))
    tcfg = enable(smoke_config(get_config("internlm2-1.8b")))
    if library_size not in _PARAMS:
        jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
        _PARAMS[library_size] = (jp, params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return jcfg, tcfg, *_PARAMS[library_size]


def test_library_checkpoint_converts_leaf_by_leaf():
    """A library model's stacks hold library_size + 1 prepadded rows and
    its router heads library_size + 1 columns; they cross unchanged."""
    jcfg, tcfg, jp, tp = _models()
    lib = jcfg.approx.library_size
    blk = tp.blocks[0].approx
    assert blk.a_w1.shape[0] == lib + 1 and blk.router.shape[1] == lib + 1
    assert tp.tick_router.shape[1] == lib + 1
    jw2 = np.asarray(jp["blocks"]["approx"]["a_w2"][0])
    np.testing.assert_array_equal(blk.a_w2.detach().numpy(), jw2)
    np.testing.assert_array_equal(tp.tick_router.detach().numpy(),
                                  np.asarray(jp["tick_router"]))


@pytest.mark.parametrize("route_scope", ["layer", "tick"])
def test_decode_residency_backends_match_jax(route_scope):
    b = 6
    mask = np.asarray([True] * 5 + [False])
    toks = np.arange(1, b + 1, dtype=np.int32)[:, None]
    res = np.asarray([3, 5], np.int32)
    outs = {}
    for be in ("xla", "pallas"):
        jcfg, tcfg, jp, tp = _models(backend=be, route_scope=route_scope,
                                     block_t=16)
        jcfg = dataclasses.replace(jcfg, approx=dataclasses.replace(
            jcfg.approx, interpret=True))
        jl, _, jm = JM.decode(jcfg, jp, JM.init_cache(jcfg, b, 32),
                              jnp.asarray(toks), serve=True,
                              collect_metrics=True, row_mask=jnp.asarray(mask),
                              residency=jnp.asarray(res))
        with torch.no_grad():
            tl, _, tm = TM.decode(tcfg, tp, TM.init_cache(tcfg, b, 32,
                                                          device="cpu"),
                                  torch.from_numpy(toks), serve=True,
                                  collect_metrics=True,
                                  row_mask=torch.from_numpy(mask),
                                  residency=torch.from_numpy(res))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for k in ("lib_counts", "off_set_exact_rows", "class_counts",
                  "dispatched"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=k)
        outs[be] = (tl.numpy(), tm["lib_counts"].numpy())
    np.testing.assert_allclose(outs["pallas"][0], outs["xla"][0], **TOL)
    np.testing.assert_array_equal(outs["pallas"][1], outs["xla"][1])
    assert outs["xla"][1].shape == (7,)
    assert float(outs["xla"][1].sum()) == 5.0


def test_residency_swap_is_data_one_step():
    """One decode step object serves every residency vector, and the
    vector changes the routing."""
    _, tcfg, _, tp = _models(route_scope="tick")
    step = TS.make_decode_step(tcfg, use_mcma_dispatch=True, with_stats=True,
                               backend="xla")
    b = 8
    toks = torch.arange(1, b + 1, dtype=torch.int32)[:, None]
    seen = []
    for res in RESIDENCIES:
        cache = TM.init_cache(tcfg, b, 16, device="cpu")
        _, _, m = step(tp, cache, toks, None,
                       residency=torch.tensor(res, dtype=torch.int32))
        seen.append(m["class_counts"].tolist())
    assert len({tuple(s) for s in seen}) > 1


# ---------------------------------------------------------------------------
# ResidencyController: the hysteresis law, replayed in both packages
# ---------------------------------------------------------------------------

def _spec(**over):
    kw = dict(library_size=6, n_resident=2, observe_window=1, cooldown=0,
              ema=1.0)
    kw.update(over)
    return LibrarySpec(**kw), JSpec(**kw)


def _replay(spec, jspec, seq):
    ctrl, jctrl = AT.ResidencyController(spec), JAT.ResidencyController(jspec)
    for lib in seq:
        res = ctrl.observe({"lib_counts": lib})
        assert res == jctrl.observe({"lib_counts": lib})
    assert ctrl.summary() == jctrl.summary()
    return ctrl, res


def test_controller_promotes_hot_off_set_class():
    lib = np.asarray([10.0, 2.0, 1.0, 0.0, 30.0, 0.0, 0.0])
    ctrl, res = _replay(*_spec(), [lib])
    assert 3 in res
    assert ctrl.history[0].promoted == 3
    assert ctrl.history[0].demoted in (0, 1)


def test_controller_ratio_gate_blocks_borderline_thrash():
    lib = np.asarray([60.0, 10.0, 10.0, 13.0, 0.0, 0.0, 0.0])
    ctrl, res = _replay(*_spec(promote_margin=1.5), [lib] * 8)
    assert res == (0, 1)
    assert not ctrl.history


def test_controller_floor_gate_protects_busy_resident():
    lib = np.asarray([0.0, 26.0, 29.0, 45.0, 0.0, 0.0, 0.0])
    ctrl, res = _replay(*_spec(demote_margin=0.25), [lib] * 8)
    assert res == (0, 1)
    assert not ctrl.history


def test_controller_cooldown_spaces_swaps():
    hot = np.zeros(7)
    hot[3] = 50.0
    hot[1] = 1.0
    ctrl, _ = _replay(*_spec(observe_window=1, cooldown=3), [hot] * 4)
    assert len(ctrl.history) == 1


def test_controller_random_stream_replays_equal():
    """A long random demand stream with the default EMA and windows: the
    two packages' controllers swap identically."""
    rng = np.random.default_rng(5)
    seq = [rng.gamma(0.6, 10.0, 7) * (rng.random(7) < 0.8)
           for _ in range(200)]
    ctrl, _ = _replay(*_spec(ema=0.3, observe_window=3, cooldown=5), seq)
    assert ctrl.history                     # the stream did swap


def test_library_spec_validation():
    with pytest.raises(AssertionError):
        LibrarySpec(library_size=2, n_resident=4)
    with pytest.raises(AssertionError):
        LibrarySpec(library_size=4, n_resident=2, promote_margin=0.5)
    with pytest.raises(AssertionError):
        LibrarySpec(library_size=4, n_resident=2, start=(0, 9))
    with pytest.raises(AssertionError):
        LibrarySpec(library_size=4, n_resident=0)
    assert LibrarySpec(4, 2).initial_residency() == (0, 1)
    assert LibrarySpec(4, 2, start=(3, 1)).initial_residency() == (3, 1)
    assert dataclasses.asdict(LibrarySpec(4, 2)) == \
        dataclasses.asdict(JSpec(4, 2))


# ---------------------------------------------------------------------------
# server end to end
# ---------------------------------------------------------------------------

def _serve(cls, req_cls, opts_cls, spec_cls, cfg, params, lib=None,
           **over):
    opts = dict(batch=4, max_len=64, use_mcma_dispatch=True,
                prefill_chunk=4, backend="xla")
    if lib is not None:
        opts["library"] = spec_cls(**lib)
    opts.update(over)
    srv = cls(cfg, params, options=opts_cls(**opts))
    rng = np.random.default_rng(0)
    reqs = [req_cls(rid=i, prompt=rng.integers(1, cfg.vocab, 6)
                    .astype(np.int32), max_new=6) for i in range(10)]
    for r in reqs:
        srv.submit(r)
    return srv, reqs, srv.run_until_drained(max_ticks=400)


def test_server_library_swaps_match_jax():
    jcfg, tcfg, jp, tp = _models()
    lib = dict(library_size=6, n_resident=2, observe_window=2, cooldown=2)
    srv, reqs, stats = _serve(DecodeServer, Request, ServeOptions,
                              LibrarySpec, tcfg, tp, lib)
    jsrv, jreqs, jstats = _serve(JServer, JRequest, JOptions, JSpec, jcfg,
                                 jp, lib)
    assert srv.cfg.approx.n_approx == 2 and srv.cfg.approx.library_size == 6
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    for k in ("lib_routed_per_class", "off_set_exact_rows",
              "routed_per_class", "dispatched_per_class", "residency",
              "ticks", "prefill_ticks"):
        assert stats[k] == jstats[k], (k, stats[k], jstats[k])
    libc = stats["lib_routed_per_class"]
    assert len(libc) == 7
    summ = stats["residency"]
    assert len(summ["final_residency"]) == 2
    assert stats["off_set_exact_rows"] <= sum(libc[1:])
    # the off-set rows are the library demand outside the resident sets
    # the ticks ran with, so they reconcile with the exact column
    assert stats["off_set_exact_rows"] == pytest.approx(
        stats["routed_per_class"][0] - libc[0])
    # swaps ran through the same two step objects
    assert_zero_retrace(srv, "a live residency swap")


def test_server_identity_residency_is_library_less():
    """Every library class resident (nothing can swap): tokens, tick log
    and stats bitwise equal to the library-less server on the same
    weights."""
    _, tcfg, _, tp = _models(library_size=3)
    lib = dict(library_size=3, n_resident=3, observe_window=1, cooldown=0)
    srv, reqs, stats = _serve(DecodeServer, Request, ServeOptions,
                              LibrarySpec, tcfg, tp, lib,
                              route_scope="tick", backend="pallas")
    plain_cfg = dataclasses.replace(tcfg, approx=dataclasses.replace(
        tcfg.approx, library_size=0))
    srv0, reqs0, stats0 = _serve(DecodeServer, Request, ServeOptions,
                                 LibrarySpec, plain_cfg, tp,
                                 route_scope="tick", backend="pallas")
    assert [r.out for r in reqs] == [r.out for r in reqs0]
    assert srv.tick_log == srv0.tick_log
    for k in ("routed_per_class", "dispatched_per_class", "dropped_rows",
              "invocation_rate", "ticks"):
        assert stats[k] == stats0[k], k
    assert stats["lib_routed_per_class"] == stats["routed_per_class"]
    assert stats["off_set_exact_rows"] == 0.0
    assert stats["residency"]["swap_count"] == 0


def test_server_library_requires_matching_config():
    _, tcfg, _, tp = _models()
    with pytest.raises(AssertionError, match="library_size"):
        DecodeServer(tcfg, tp, options=ServeOptions(
            use_mcma_dispatch=True,
            library=LibrarySpec(library_size=4, n_resident=2)))
    with pytest.raises(AssertionError, match="dispatch engine"):
        DecodeServer(tcfg, tp, options=ServeOptions(
            library=LibrarySpec(library_size=6, n_resident=2),
            use_mcma_dispatch=False))


# ---------------------------------------------------------------------------
# train_library: error-clustered co-training at library scale
# ---------------------------------------------------------------------------

def test_train_library_smoke():
    from repro_torch.apps.registry import get_app, make_dataset
    from repro_torch.core.mcma import train_library
    app = get_app("fft")
    x, y, xt, yt = make_dataset(app, torch.Generator().manual_seed(0), 256,
                                128)
    m = train_library(app, torch.Generator().manual_seed(1), x, y,
                      library_size=4, iters=2, epochs=40, lr=1e-2)
    assert m.n_approx == 4
    assert len(m.history) == 2
    cls = m.classify(xt)
    assert cls.dtype == torch.int32
    assert int(cls.min()) >= 0 and int(cls.max()) <= 4   # library classes + nC
