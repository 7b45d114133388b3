"""Decode at and past the cache end, through both packages (smoke internlm2,
ApproxFFN on, float32, converted JAX parameters).

The reference's decode step returns logits at ``pos >= max_len``: a dense
cache's ``dynamic_update_slice`` clamps the write onto row ``max_len - 1``,
and a paged cache clamps the page index onto the block table's last entry
and writes at ``pos % page_size`` (a -1 entry drops the write).  The port
computes the same with tensor ops, and ``model.decode`` reads nothing on
the host.  Logits and the whole cache within rtol = atol = 3e-5.
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
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
PAGE, PAGES_PER_SLOT = 4, 4
MAX_LEN = PAGE * PAGES_PER_SLOT
# one slot each before, at and past the cache end, one mid-sequence
POS = {"dense": [MAX_LEN - 1, MAX_LEN, MAX_LEN + 1, 3],
       "paged": [MAX_LEN - 1, MAX_LEN, MAX_LEN + 1, MAX_LEN]}


def _models():
    def enable(cfg):
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    jcfg = enable(jsmoke(jget_config("internlm2-1.8b")))
    tcfg = enable(smoke_config(get_config("internlm2-1.8b")))
    jp = JM.init_model(jax.random.PRNGKey(4), jcfg)
    return jcfg, tcfg, jp, params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_at_and_past_cache_end_matches_jax(layout):
    jcfg, tcfg, jparams, tparams = _models()
    b = 4
    n_pages = b * PAGES_PER_SLOT        # every slot owns its pages
    kw = dict(page_size=PAGE, kv_pages=n_pages) if layout == "paged" else {}
    jcache = JM.init_cache(jcfg, b, MAX_LEN, **kw)
    tcache = TM.init_cache(tcfg, b, MAX_LEN, device="cpu", **kw)
    rng = np.random.default_rng(0)
    n = jcache["k"].shape[1]            # the reference's extent
    for key in ("k", "v"):
        fill = rng.normal(size=jcache[key].shape).astype(np.float32)
        jcache[key] = jnp.asarray(fill)
        tcache[key][:, :n].copy_(torch.from_numpy(fill))
    pos = np.asarray(POS[layout], np.int32)
    jcache["pos"] = jnp.asarray(pos)
    tcache["pos"].copy_(torch.from_numpy(pos))
    if layout == "paged":
        # slot 3's last entry is unallocated, so its write past the end
        # is dropped (the port's trash page)
        bt = np.arange(n_pages, dtype=np.int32).reshape(b, -1)
        bt[3, -1] = -1
        jcache["block_table"] = jnp.asarray(bt)
        tcache["block_table"].copy_(torch.from_numpy(bt))
    toks = rng.integers(1, 512, (b, 1)).astype(np.int32)
    jl, jcache = JM.decode(jcfg, jparams, jcache, jnp.asarray(toks))
    with torch.no_grad():
        tl, tcache = TM.decode(tcfg, tparams, tcache, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :n].numpy(),
                                   np.asarray(jcache[key]), **TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert tcache["pos"].tolist() == (pos + 1).tolist()
