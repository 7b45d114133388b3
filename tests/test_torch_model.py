"""The PyTorch port's dense model against the JAX reference: the smoke
internlm2 config with the ApproxFFN enabled, JAX-initialized parameters
converted into the port, decoded for 8 ticks on each dispatch backend.

Logits within 3e-5 (float32 smoke config), greedy tokens and the
per-tick dispatch counts equal.
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
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

B, MAX_LEN, TICKS = 8, 16, 8


def _cfgs():
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    return (enable(jsmoke(jget_config("internlm2-1.8b"))),
            enable(smoke_config(get_config("internlm2-1.8b"))))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_conversion_is_total_and_exact(models):
    jcfg, tcfg, jparams, tparams = models
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    own = dict(tparams.named_parameters())
    n_leaves = sum(v.shape[0] if k.startswith("['blocks']") else 1
                   for k, v in flat.items())
    assert len(own) == n_leaves
    np.testing.assert_array_equal(
        flat["['blocks']['approx']['a_w1']"][1],
        own["blocks.1.approx.a_w1"].numpy())
    np.testing.assert_array_equal(flat["['tick_router']"],
                                  own["tick_router"].numpy())


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "xla"])
def test_decode_matches_jax(models, backend):
    jcfg, tcfg, jparams, tparams = models
    jstep = jax.jit(JS.make_decode_step(jcfg, use_mcma_dispatch=True,
                                        with_stats=True, backend=backend),
                    donate_argnums=(1,))
    tstep = TS.make_decode_step(tcfg, use_mcma_dispatch=True,
                                with_stats=True, backend=backend)
    jcache = JM.init_cache(jcfg, B, MAX_LEN)
    tcache = TM.init_cache(tcfg, B, MAX_LEN, device="cpu")
    mask = np.asarray([True] * 6 + [False] * 2)
    toks = np.arange(1, B + 1, dtype=np.int32)[:, None]
    for tick in range(TICKS):
        jl, jcache, jm = jstep(jparams, jcache, jnp.asarray(toks),
                               jnp.asarray(mask))
        tl, tcache, tm = tstep(tparams, tcache, torch.from_numpy(toks),
                               torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-5,
                                   atol=3e-5, err_msg=f"tick {tick}")
        for k in ("class_counts", "dispatched", "dropped_rows"):
            np.testing.assert_array_equal(np.asarray(jm[k]), tm[k].numpy(),
                                          err_msg=f"{k} tick {tick}")
        np.testing.assert_allclose(float(tm["invocation"]),
                                   float(jm["invocation"]), atol=1e-6)
        nxt = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(nxt, tl.argmax(-1).numpy())
        toks = nxt.astype(np.int32)[:, None]
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=3e-5, atol=3e-5)


def test_reset_slot_and_cache_end(models):
    _, tcfg, _, tparams = models
    step = TS.make_decode_step(tcfg, use_mcma_dispatch=True)
    cache = TM.init_cache(tcfg, 2, 2, device="cpu")
    toks = torch.ones((2, 1), dtype=torch.int32)
    for _ in range(2):
        _, cache = step(tparams, cache, toks)
    # at the cache end the step decodes as the reference's does: logits,
    # and the write clamped onto the last row (dynamic_update_slice)
    k_before = cache["k"].clone()
    lg, cache = step(tparams, cache, toks)
    assert torch.isfinite(lg).all() and cache["pos"].tolist() == [3, 3]
    assert torch.equal(cache["k"][:, :, 0], k_before[:, :, 0])
    assert not torch.equal(cache["k"][:, :, 1], k_before[:, :, 1])
    TM.reset_slot(tcfg, cache, TM.init_cache(tcfg, 2, 2, device="cpu"), 0)
    assert cache["pos"].tolist() == [0, 3]
    assert not cache["k"][:, 0].any() and cache["k"][:, 1].any()
