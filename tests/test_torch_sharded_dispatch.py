"""The port's mesh serving path on an 8-rank gloo world on the CPU: a
(4, 2) ("data", "model") mesh, one process per rank
(tests/_torch_mesh_world.py), started once for the module; every case
runs in that one world and each rank returns one payload.

Held:
  * ``mcma_dispatch_sharded`` on the reference's case
    (tests/test_sharded_dispatch.py ``_CASE``: 256 rows of width 64, three
    approximators of width 16, per-shard capacities 16 / 12, drawn here
    from a numpy seed), bare, with a row mask, with QoS tiers, with
    library residency and with all three, on the oracle and both kernel
    twins: outputs within 3e-5 of the reference's ``mcma_dispatch`` (its
    oracle) run per data shard on one device, the global stats exactly
    the sums of the shards' stats from the reference's plans on the same
    backend (what the reference's own test proves its sharded engine
    against);
  * the mesh ``DecodeServer`` on ``smoke_config(internlm2-1.8b)``
    (float32): the reference's stream at layer scope; a six-request
    stream at tick scope with chunk 64 and pages; then with QoS tiers, a
    library of 6 (3 resident) and autotune: greedy tokens, tick log and
    drain counters equal to the port's single-device server's (at
    no-clip capacities where per-shard drops would differ), tokens equal
    to the reference's single-device server's;
  * every rank's payload is bitwise equal to rank 0's.

The reference's own mesh server cannot be the yardstick on this jax
(ROADMAP queue 3, caveat b), so the mesh is held to the single device.
"""
import dataclasses
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_mesh_world as W  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime.autotune import OperatingPoint as JPoint  # noqa: E402
from repro.runtime.options import LibrarySpec as JSpec  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.convert import _empty_paths, _stack  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.autotune import OperatingPoint  # noqa: E402
from repro_torch.runtime.options import LibrarySpec, ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
N_RANKS = W.MESH[0] * W.MESH[1]
INT_STATS = ("class_counts", "dispatched", "dropped", "executed_rows",
             "padding_rows", "tier_counts", "tier_dispatched",
             "tier_dropped", "lib_counts", "off_set_exact_rows")


def _dispatch_inputs() -> dict:
    """The reference's ``_CASE`` (its sizes, scales and per-shard
    capacities for 8 shards of 32 rows), with a row mask, tiers and a
    prepadded library of 5 (3 resident) with library-wide logits."""
    t, n, d, dh, block, devs = 256, 3, 64, 16, 32, 8
    tl = t // devs
    rng = np.random.default_rng(0)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x = f(t, d, sc=0.5)
    case = dict(x=x, logits=x @ f(d, n + 1, sc=0.5),
                w1=f(n, d, dh, sc=0.2), b1=f(n, dh, sc=0.1),
                w2=f(n, dh, d, sc=0.2), b2=f(n, d, sc=0.1),
                wi=f(d, 2 * d, sc=0.1), wo=f(2 * d, d, sc=0.1),
                EC=tl // 2, IC=max(int(tl * 0.4), 1), BLOCK=block)
    lib = 5
    w_lib = [np.asarray(w) for w in jops.prepad_switched_weights(
        f(lib, d, dh, sc=0.2), f(lib, dh, sc=0.1), f(lib, dh, d, sc=0.2),
        f(lib, d, sc=0.1))]
    return dict(
        case, logits_lib=x @ f(d, lib + 1, sc=0.5),
        w1_lib=w_lib[0], b1_lib=w_lib[1], w2_lib=w_lib[2], b2_lib=w_lib[3],
        mask=rng.random(t) < 0.8,
        tier=rng.integers(0, 3, t).astype(np.int32),
        margins=np.asarray([1.0, 0.0, -1.0], np.float32),
        residency=np.asarray([4, 0, 2], np.int32))


def _jcfg(name):
    case = W.SERVERS[name]
    cfg = jsmoke(jget_config("internlm2-1.8b"))
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, library_size=case["library"],
        **case["approx"]))


def _params(name):
    """The port's random parameters for serving case ``name`` (seed 0) as
    {name: ndarray}, and the same as the reference's pytree."""
    cfg = W.port_cfg(name)
    model = TM.init_model(0, cfg, device="cpu")
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    tree = _stack(cfg, dict(model.named_parameters()),
                  _empty_paths(cfg, model))
    return state, jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                               tree)


def _reference_dispatch(inp, case):
    """The reference's engine on each data shard's rows with the per-shard
    capacities: ``mcma_dispatch``'s outputs in row order (the "xla"
    oracle; both kernel twins are held to it within the tolerance), and
    for each backend the stats summed over the shards, from the plans
    ``mcma_dispatch`` derives them from (``make_dispatch_plan`` +
    ``plan_invoke_stats``, exact per backend: the executed and padding
    rows differ between the oracle and the kernels)."""
    lib = case in ("residency", "all")
    sfx = "_lib" if lib else ""
    w = [jnp.asarray(inp[k + sfx]) for k in ("w1", "b1", "w2", "b2")]
    wi, wo = jnp.asarray(inp["wi"]), jnp.asarray(inp["wo"])
    logits = inp["logits" + sfx]
    shards = W.MESH[0]
    tl = inp["x"].shape[0] // shards
    caps = dict(exact_cap=int(inp["EC"]), invoke_cap=int(inp["IC"]),
                block_t=int(inp["BLOCK"]))
    ys, acc, t_total = [], {be: {} for be in W.BACKENDS}, 0
    for i in range(shards):
        rows = slice(i * tl, (i + 1) * tl)
        kw = {}
        if case in ("mask", "all"):
            kw["row_mask"] = jnp.asarray(inp["mask"][rows])
        if case in ("tiers", "all"):
            kw["tier"] = jnp.asarray(inp["tier"][rows])
            kw["tier_margins"] = jnp.asarray(inp["margins"])
        if lib:
            kw["residency"] = jnp.asarray(inp["residency"])
        lg = jnp.asarray(logits[rows])
        y, _ = JD.mcma_dispatch(
            jnp.asarray(inp["x"][rows]), lg,
            lambda xb: jnp.dot(jax.nn.silu(jnp.dot(xb, wi)), wo), *w,
            backend="xla", weights_prepadded=lib, **caps, **kw)
        ys.append(np.asarray(y))
        mask = kw.pop("row_mask", None)
        for be in W.BACKENDS:
            st = JD.plan_invoke_stats(JD.make_dispatch_plan(
                lg, mask, backend=be, **caps, **kw))
            for k in INT_STATS:
                acc[be][k] = acc[be].get(k, 0) + np.asarray(st[k])
        t_total += int(inp["mask"][rows].sum()) if mask is not None else tl
    return np.concatenate(ys), acc, t_total


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's payloads, the inputs, and the parent's own runs (the
    references and the port's single-device servers), made while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("mesh_world")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # the parent's torch beside 8 ranks
    (state, jtree), (state_lib, jtree_lib) = _params("tick"), \
        _params("qos_library_autotune")
    jparams = {0: jtree, 6: jtree_lib}
    inputs = {"dispatch": _dispatch_inputs(), "params": state,
              "params_lib": state_lib}
    torch.save(inputs, tmp / "inputs.pt")
    errors = []

    def ranks():
        try:
            spawn_world(W.run, N_RANKS, (str(tmp),),
                        init_method=f"file://{tmp}/rendezvous",
                        exchange_mib=1)
        except Exception as e:                 # re-raised below
            errors.append(e)
    th = threading.Thread(target=ranks)
    th.start()
    ref = {"dispatch": {}, "single": {}, "jax": {}}
    try:
        for case in W.DISPATCH_CASES:
            ref["dispatch"][case] = _reference_dispatch(inputs["dispatch"],
                                                        case)
        for name in W.SERVERS:
            if name == "default_ladder":
                continue
            n_lib = W.SERVERS[name]["library"]
            cfg = W.port_cfg(name)
            state = inputs["params_lib" if n_lib else "params"]
            ref["single"][name] = W.serve(
                name, cfg, W.port_model(cfg, state), DecodeServer, Request,
                ServeOptions, LibrarySpec, OperatingPoint)
            ref["jax"][name] = W.serve(
                name, _jcfg(name), jparams[n_lib], JServer, JRequest,
                JOptions, JSpec, JPoint)
    finally:
        torch.set_num_threads(threads)
        th.join()
    if errors:
        raise errors[0]
    payloads = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(N_RANKS)]
    return inputs, payloads, ref


def _same(a, b) -> bool:
    """Bitwise equality of nested payloads."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and \
            a.tobytes() == b.tobytes()
    return a == b and type(a) is type(b)


def test_every_rank_agrees_bitwise(world):
    _, payloads, _ = world
    assert sorted(tuple(p["coords"].values()) for p in payloads) == \
        [(d, m) for d in range(W.MESH[0]) for m in range(W.MESH[1])]
    for r, p in enumerate(payloads[1:], 1):
        assert _same(p["dispatch"], payloads[0]["dispatch"]), r
        assert _same(p["servers"], payloads[0]["servers"]), r


def test_sharded_dispatch_audit_is_clean(world):
    """``repro_torch.analysis.audit.audit_sharded`` on the (4, 2) mesh,
    every backend: int32 stats and no host sync in the sharded engine,
    nothing the port's baseline does not grandfather, on every rank."""
    from pathlib import Path

    from repro_torch.analysis.findings import load_baseline
    _, payloads, _ = world
    baseline = load_baseline(Path(__file__).resolve().parents[1]
                             / "analysis_baseline_torch.txt")
    for r, p in enumerate(payloads):
        assert set(p["audit"]) <= baseline, (r, p["audit"])


def test_production_mesh_refuses_another_world(world):
    """(16, 16) and (2, 16, 16) need 256 and 512 ranks; a world of 8
    raises (even ranks asked for the one, odd for the other)."""
    _, payloads, _ = world
    for r, p in enumerate(payloads):
        want = "(2, 16, 16) mesh needs 512" if r % 2 \
            else "(16, 16) mesh needs 256"
        assert want in p["production_mesh"], (r, p["production_mesh"])


@pytest.mark.parametrize("backend", W.BACKENDS)
@pytest.mark.parametrize("case", W.DISPATCH_CASES)
def test_sharded_dispatch_matches_reference_per_shard(world, case, backend):
    inputs, payloads, ref = world
    y, st = payloads[0]["dispatch"][backend, case]
    jy, jst, t_total = ref["dispatch"][case]
    jst = jst[backend]
    np.testing.assert_allclose(y, jy, **TOL)
    for k in INT_STATS:
        np.testing.assert_array_equal(st[k], jst[k], err_msg=k)
        assert st[k].dtype == np.int32, k
    counts = jst["class_counts"]
    assert int(counts.sum()) == t_total
    assert float(st["invocation"]) == pytest.approx(
        1.0 - counts[0] / max(t_total, 1), abs=1e-6)
    if case in ("tiers", "all"):
        rows = jst["tier_counts"].sum(-1)
        np.testing.assert_allclose(
            st["tier_served_invocation"],
            jst["tier_dispatched"][:, 1:].sum(-1) / np.maximum(rows, 1),
            atol=1e-6)


DRAIN_KEYS = ("ticks", "prefill_ticks", "prefill_tokens", "invocation_rate",
              "prefill_invocation_rate", "dropped_rows", "routed_per_class",
              "dispatched_per_class", "dropped_frac",
              "served_invocation_rate", "per_tier", "autotune",
              "lib_routed_per_class", "off_set_exact_rows", "residency",
              "pages_in_use", "page_hwm", "alloc_failures", "page_util",
              "kv_bytes_resident", "undrained_queued", "undrained_inflight")


@pytest.mark.parametrize("name", ["layer", "tick", "qos_library_autotune"])
def test_mesh_server_matches_single_device(world, name):
    _, payloads, ref = world
    toks, aborted, stats, log, counts = payloads[0]["servers"][name]
    stoks, saborted, sstats, slog = ref["single"][name]
    assert not any(aborted) and toks == stoks
    assert log == slog
    assert stats.keys() - {"wall_s"} == sstats.keys() - {"wall_s"}
    for k in DRAIN_KEYS:
        assert stats.get(k) == sstats.get(k), k
    # the sharded path ran: collectives over both axes every tick
    assert counts["all_reduce"] > 0 and counts["all_gather"] > 0
    assert counts["staged"] == 0             # CPU tensors: nothing staged


@pytest.mark.parametrize("name", ["layer", "tick", "qos_library_autotune"])
def test_mesh_server_tokens_match_reference(world, name):
    _, payloads, ref = world
    toks = payloads[0]["servers"][name][0]
    jtoks, jaborted = ref["jax"][name][:2]
    assert not any(jaborted) and toks == jtoks


def test_mesh_server_default_ladder_serves(world):
    """The default capacities and ladder on the mesh: every request
    served, the rates in [0, 1], the rungs the controller's (per-shard
    drops make it a run of its own, held only rank to rank)."""
    _, payloads, _ = world
    toks, aborted, stats, _, _ = payloads[0]["servers"]["default_ladder"]
    assert not any(aborted) and all(len(t) == 6 for t in toks)
    assert 0.0 <= stats["invocation_rate"] <= 1.0
    assert 0.0 <= stats["served_invocation_rate"] <= 1.0
    assert len(stats["per_tier"]) == 3
    assert stats["autotune"]["final_index"] >= 0
