"""The PyTorch port's DecodeServer against the JAX reference's: one
request stream through both on the smoke internlm2 config (converted
JAX parameters, token-by-token prefill).  Tokens and the DrainStats
counters must be equal, the invocation rate within 1e-6.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _enable(cfg):
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))


@pytest.fixture(scope="module")
def models():
    jcfg = _enable(jsmoke(jget_config("internlm2-1.8b")))
    tcfg = _enable(smoke_config(get_config("internlm2-1.8b")))
    jparams = JM.init_model(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _stream(seed=0, n=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(2, 9))).astype(np.int32),
             int(rng.integers(3, 9))) for _ in range(n)]


@pytest.mark.parametrize("backend,admission",
                         [("pallas", "cost"), ("pallas_fused", "fifo")])
def test_server_matches_jax(models, backend, admission):
    jcfg, tcfg, jparams, tparams = models
    kw = dict(batch=4, max_len=24, use_mcma_dispatch=True, backend=backend,
              admission=admission, prefill_chunk=0)
    js = JServer(jcfg, jparams, options=JOptions(**kw))
    ts = DecodeServer(tcfg, tparams, options=ServeOptions(**kw))
    jreqs = [JRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(_stream())]
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(_stream())]
    for r in jreqs:
        js.submit(r)
    for r in treqs:
        ts.submit(r)
    jst, tst = js.run_until_drained(), ts.run_until_drained()
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and not tr.aborted
        assert tr.out == jr.out, (tr.rid, tr.out, jr.out)
        assert (tr.arrival_tick, tr.first_token_tick) == \
            (jr.arrival_tick, jr.first_token_tick)
    for k in ("ticks", "routed_per_class", "dispatched_per_class",
              "dropped_rows", "undrained_queued", "undrained_inflight",
              "kv_bytes_resident"):
        assert tst[k] == jst[k], (k, tst[k], jst[k])
    assert abs(tst["invocation_rate"] - jst["invocation_rate"]) <= 1e-6
    assert abs(tst["served_invocation_rate"]
               - jst["served_invocation_rate"]) <= 1e-6


def test_submit_contract_and_sampling(models):
    _, tcfg, _, tparams = models
    srv = DecodeServer(tcfg, tparams, options=ServeOptions(
        batch=2, max_len=8, overflow="trim", greedy=False, seed=3))
    r = Request(rid=0, prompt=np.arange(1, 10), max_new=3)
    srv.submit(r)
    assert r.prompt.tolist() == [5, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit(Request(rid=1, prompt=np.zeros((0,), np.int32)))
    with pytest.raises(ValueError, match="cannot trim"):
        srv.submit(Request(rid=2, prompt=np.ones(3), max_new=8))
    stats = srv.run_until_drained()
    assert r.done and len(r.out) == 3 and stats["ticks"] == 7
    assert "invocation_rate" not in stats
    strict = DecodeServer(tcfg, tparams, options=ServeOptions(batch=1,
                                                              max_len=8))
    with pytest.raises(ValueError, match="exceeds max_len"):
        strict.submit(Request(rid=3, prompt=np.arange(8), max_new=2))
    assert isinstance(stats.asdict(), dict) and stats.get("nope") is None
    assert torch.equal(srv.cache["pos"], torch.tensor([7, 0],
                                                      dtype=torch.int32))
