"""Tensor parallelism below one kv head or one expert a rank: the port on
a (2, 4) ("data", "model") mesh of 8 gloo ranks on the CPU
(tests/_torch_narrow_world.py, one world for the module) whose model axis
of 4 is wider than the smoke configs' kv heads (internlm2: 2, mixtral: 1)
and than an MoE's 2 or 6 experts, in float32, against the reference on
one device and the port on one device.

Held:
  * ``check_mesh_servable`` / ``check_mesh_trainable`` accept kv heads
    below |model| when |model| is a multiple of them and head_dim divides
    (the head_dim-split cache of ``rules._cache_rule``), and experts that
    do not divide when each expert's d_ff does (TP-in-expert, as
    ``rules._param_rule``); every other width still raises (no world);
  * attention with a head_dim-split cache, each path within 3e-5 of the
    reference's ``attention_fwd`` on the same parameters: the flash
    prefill (mixtral's past its window), dense decode at and past the
    cache end, paged decode with holes (the trash page), chunked prefill
    dense and paged with padding and past-the-end tokens, and the ring
    buffer from wrapped and unwrapped positions; each rank's cache shard
    equal to its ``cache_pspecs`` slice of the reference's cache; the
    prefill's gradients within 1e-4 of the port's single device; decode
    exchanging partial scores and the chunk gathering the kv head (the
    cheaper exchange at these widths);
  * TP-in-expert at 2 and 6 experts: outputs and aux within 3e-5 of the
    reference's single-device ``_moe_chunked`` (the same global groups:
    one group over both data ranks, groups that a data rank's tokens cut,
    whole groups per rank), ``gate_idx`` and every (token, choice)'s kept
    flag exactly equal, the drop count equal, gradients within 1e-4;
  * the mesh ``DecodeServer`` on smoke internlm2 through both switch
    backends, dense and paged, chunked, and on smoke mixtral at 2
    experts: tokens and the tick log equal to the port's single device,
    tokens equal to the reference's single device, paged == dense and
    fused == unfused;
  * every rank of a data shard bitwise equal; every rank's server and
    trainer results equal;
  * ``Trainer(mesh=)`` on both for two steps: losses and parameters
    within 1e-4 of the port's single device, and the checkpoint it wrote
    restores on one device to the parameters the mesh held.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_narrow_world as W  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch.mesh import MeshShape, spawn_world  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

D_RANKS, M_RANKS = W.MESH


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the predicate (no world)
# ---------------------------------------------------------------------------

def _widths(arch, **over):
    cfg = smoke_config(get_config(arch))
    moe = over.pop("moe", {})
    if moe:
        over["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **over)


# (arch, overrides, mesh): smoke internlm2's 2 kv heads over 4 and 8
# (head_dim 16), smoke mixtral's one kv head over 4 with 2 and 6 experts
# (d_ff 128), the experts dividing (expert parallelism) beside it
ACCEPTED = {
    "kv-heads-2-over-4": ("internlm2-1.8b", {}, (2, 4)),
    "kv-heads-2-over-8": ("internlm2-1.8b", {"n_heads": 8}, (1, 8)),
    "kv-head-1-over-4-experts-2": ("mixtral-8x7b", {"moe": {"n_experts": 2}},
                                   (2, 4)),
    "kv-head-1-over-4-experts-6": ("mixtral-8x7b", {"moe": {"n_experts": 6}},
                                   (1, 4)),
    "experts-4-over-4": ("mixtral-8x7b", {}, (2, 4)),
}
# (arch, overrides, mesh, what the refusal names)
REFUSED = {
    "head_dim-not-dividing": (
        "internlm2-1.8b", {"head_dim": 18}, (1, 4),
        r"head_dim \(kv heads=2 below model\)=18"),
    "kv-heads-not-a-divisor-of-model": (
        "internlm2-1.8b", {"n_heads": 12, "n_kv_heads": 3}, (1, 4),
        "heads=12, kv heads=3, d_ff"),
    "q-heads-over-model": (
        "internlm2-1.8b", {}, (1, 8), "heads=4"),
    "experts-and-d_ff-not-dividing": (
        "mixtral-8x7b", {"moe": {"n_experts": 6}, "d_ff": 126}, (1, 4),
        r"d_ff \(experts=6, TP-in-expert\)=126"),
    # a batch below the data axes serves (its rows whole on every data
    # rank) unless its cache length divides over them neither; a
    # microbatch there trains split by sequence unless its sequence does
    # not divide over them either
    "batch-over-data": ("internlm2-1.8b", {}, (3, 4),
                        {"serve": "KV cache of 40 rows for a batch of 4",
                         "train": r"microbatch 4 \(.*or below them its 40 "
                                  "positions over them"}),
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_predicate_accepts_the_narrow_layouts(case, train):
    arch, over, shape = ACCEPTED[case]
    cfg = _widths(arch, **over)
    check = TM.check_mesh_trainable if train else TM.check_mesh_servable
    check(cfg, MeshShape(shape), 4 * shape[0])
    md = shape[1]
    assert TL.kv_split(cfg, md) == (cfg.n_kv_heads < md)
    assert TMOE.tp_in_expert(cfg, md) == bool(
        cfg.moe.n_experts and cfg.moe.n_experts % md)


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_predicate_refuses_every_other_width(case, train):
    arch, over, shape, match = REFUSED[case]
    if isinstance(match, dict):
        match = match["train" if train else "serve"]
    cfg = _widths(arch, **over)
    check = TM.check_mesh_trainable if train else TM.check_mesh_servable
    with pytest.raises(NotImplementedError,
                       match=match + ".*ROADMAP queue 3"):
        check(cfg, MeshShape(shape), 4,
              **{"seq" if train else "max_len": W.CACHE["max_len"]})


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _jcfg_attn(arch):
    return W.attn_cfg(jsmoke, jget_config, arch)


def _attn_inputs(arch, rng, key):
    """The reference's parameters, x and w, and for each cache case the
    cache as the port holds it (paged: its trash page appended) and the
    steps."""
    jcfg = _jcfg_attn(arch)
    p = jax.tree.map(np.asarray, JL.init_attn(key, jcfg))
    b, s = W.ATTN[arch]["batch"], W.ATTN[arch]["seq"]
    d, kvh, hd = jcfg.d_model, jcfg.n_kv_heads, jcfg.hd
    normal = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    out = {"params": p, "x": normal(b, s, d) * 0.5, "w": normal(b, s, d),
           "caches": {}}
    cases = {}
    if jcfg.sliding_window:
        pos = np.asarray(W.RING["pos"], np.int32)
        cases["ring"] = ({"k": normal(b, jcfg.sliding_window, kvh, hd),
                          "v": normal(b, jcfg.sliding_window, kvh, hd),
                          "pos": pos},
                         [(normal(b, 1, d), (pos + j)[:, None])
                          for j in range(W.RING["steps"])], None)
    else:
        ml, pg, n_pg = W.CACHE["max_len"], W.CACHE["page"], W.CACHE["n_pages"]
        bt = np.asarray(W.BLOCK_TABLE, np.int32)
        pos = np.asarray(W.DECODE_POS, np.int32)
        cpos = np.asarray(W.CHUNK["pos"], np.int32)
        nv = np.asarray(W.CHUNK["n_valid"], np.int32)
        chunk = [(normal(b, W.CHUNK["seq"], d),
                  cpos[:, None] + np.arange(W.CHUNK["seq"])[None])]
        for paged in (False, True):
            shape = (n_pg, pg, kvh, hd) if paged else (b, ml, kvh, hd)
            extra = {"block_table": bt} if paged else {}
            tag = "paged_" if paged else ""
            cases[tag + "decode"] = ({"k": normal(*shape),
                                      "v": normal(*shape), "pos": pos,
                                      **extra},
                                     [(normal(b, 1, d), pos[:, None])], None)
            cases[tag + "chunk"] = ({"k": normal(*shape), "v": normal(*shape),
                                     "pos": cpos, **extra}, chunk, nv)
    for name, (cache, steps, nv) in cases.items():
        port = dict(cache)
        if "block_table" in cache:
            trash = np.zeros((1,) + cache["k"].shape[1:], np.float32)
            port["k"] = np.concatenate([cache["k"], trash])
            port["v"] = np.concatenate([cache["v"], trash])
        out["caches"][name] = {"cache": port, "steps": steps,
                               **({} if nv is None else {"n_valid": nv})}
        out["caches"][name]["ref_cache"] = cache
    return out


def _reference_attn(arch, inp):
    """The reference's prefill and every cache case, step by step."""
    jcfg = _jcfg_attn(arch)
    fwd = jax.jit(lambda *a: JL.attention_fwd(jcfg, *a))
    p = jax.tree.map(jnp.asarray, inp["params"])
    s = inp["x"].shape[1]
    y, kv = fwd(p, jnp.asarray(inp["x"]), jnp.arange(s)[None])
    out = {"prefill": {"out": np.asarray(y),
                       "cache": {k: np.asarray(v) for k, v in kv.items()}}}
    for name, c in inp["caches"].items():
        cache = {k: jnp.asarray(v) for k, v in c["ref_cache"].items()}
        ys = []
        for xs, ps in c["steps"]:
            if "n_valid" in c:
                cache["n_valid"] = jnp.asarray(c["n_valid"])
            o, cache = fwd(p, jnp.asarray(xs), jnp.asarray(ps), cache)
            cache = {k: v for k, v in cache.items() if k != "n_valid"}
            ys.append(np.asarray(o))
        out[name] = {"out": np.stack(ys),
                     "cache": {k: np.asarray(v) for k, v in cache.items()}}
    return out


def _single_attn_grads(arch, inp):
    """The port on one device: the prefill's gradients of sum(out * w)."""
    cfg = W.attn_cfg(smoke_config, get_config, arch)
    p = TL.Attention(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(v)
                       for k, v in inp["params"].items()})
    p.requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y, _ = TL.attention_fwd(cfg, p, x, torch.arange(x.shape[1])[None])
    named = dict(p.named_parameters())
    g = torch.autograd.grad((y * torch.from_numpy(inp["w"])).sum(),
                            [x, *named.values()])
    return {"x": g[0].numpy(), **{k: v.numpy() for k, v in zip(named, g[1:])}}


def _jcfg_moe(e, ck):
    return W.moe_cfg(jsmoke, jget_config, e, ck)


def _reference_moe(e, case, rng, key):
    """Inputs and the reference's ``_moe_chunked``: output, aux, gradients
    of sum(out * w) + aux, and each (token, choice)'s kept flag from its
    group's routing (``_moe_group``'s lines)."""
    b, s, ck = W.MOE_CASES[case]
    jcfg = _jcfg_moe(e, ck)
    p = jax.tree.map(np.asarray, JMOE.init_moe(key, jcfg))
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32) * 0.5
    w = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p_, x_):
        y, aux = JMOE._moe_chunked(jcfg, p_, x_)
        return jnp.sum(y * jnp.asarray(w)) + aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                             jnp.asarray(x))
    t, k = b * s, jcfg.moe.top_k
    g = ck if ck and t > ck and t % ck == 0 else t
    cap = min(int(jcfg.moe.capacity_factor * g * k / e) + 1, g)

    @jax.jit
    def route(xg):
        probs = jax.nn.softmax(jnp.dot(xg, jnp.asarray(
            p["router"])).astype(jnp.float32), -1)
        _, idx = jax.lax.top_k(probs, k)
        order, e_sorted, rank, _ = JD.class_sort_ranks(idx.reshape(-1), e)
        keep, _ = JD.capacity_slots(e_sorted, rank, cap, n_local=e)
        return idx, order, keep
    kept, gate_idx = [], []
    for xg in x.reshape(t // g, g, -1):
        idx, order, keep = route(jnp.asarray(xg))
        flat = np.zeros(g * k, bool)
        flat[np.asarray(order)] = np.asarray(keep)
        kept.append(flat.reshape(g, k))
        gate_idx.append(np.asarray(idx))
    return ({"params": p, "x": x, "w": w},
            {"y": np.asarray(y), "aux": np.asarray(aux),
             "kept": np.concatenate(kept), "gate_idx": np.concatenate(
                 gate_idx), "grads": {"x": np.asarray(gx), **{
                     n: np.asarray(v) for n, v in gp.items()}}})


def _reference_server(arch, tree, prompts):
    jcfg = W.serve_cfg(jsmoke, jget_config, arch)
    srv = JServer(jcfg, jax.tree.map(jnp.asarray, tree),
                  options=JOptions(**W.serve_options(arch)))
    reqs = [JRequest(rid=i, prompt=p.copy(), max_new=W.SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained(2000)
    return [list(map(int, r.out)) for r in reqs]


def _single(inputs, tmp):
    """The port on one device: the attention gradients, every server
    run and both trainers."""
    out = {"grads": {a: _single_attn_grads(a, inputs["attn"][a])
                     for a in W.ATTN}, "serve": {}, "train": {}}
    for arch in (W.DENSE, W.SWA):
        cfg = W.serve_cfg(smoke_config, get_config, arch)
        runs = W.SERVE_RUNS if arch == W.DENSE else (("pallas", 0),)
        for backend, page in runs:
            out["serve"][arch, backend, page] = W.serve(
                cfg, W.model(cfg, inputs["serve"][arch]), inputs["prompts"],
                W.serve_options(arch, backend, page))
        tr = W.trainer(W.train_cfg(smoke_config, get_config, arch),
                       str(tmp / f"single_ckpt_{arch}"))
        tr.run()
        out["train"][arch] = {"history": tr.history,
                              "params": W.gathered_params(tr.state)}
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory, one_thread):
    """The ranks' payloads, the inputs, and the parent's own runs (the
    reference's attention, MoE and single-device servers, the port on
    one device), made while the ranks run."""
    tmp = tmp_path_factory.mktemp("narrow_world")

    def ranks():
        spawn_world(W.run, W.RANKS, (str(tmp),),
                    init_method=f"file://{tmp}/rendezvous", exchange_mib=1)

    with ThreadPoolExecutor(3) as pool:
        world_run = pool.submit(ranks)
        try:
            rng = np.random.default_rng(0)
            key = jax.random.PRNGKey(0)
            attn = {a: _attn_inputs(a, rng, jax.random.fold_in(key, i))
                    for i, a in enumerate(W.ATTN)}
            moe_in, moe_ref = {}, {}
            for i, e in enumerate(W.MOE_EXPERTS):
                for j, case in enumerate(W.MOE_CASES):
                    moe_in[e, case], moe_ref[e, case] = _reference_moe(
                        e, case, rng, jax.random.fold_in(key, 10 + 3 * i + j))
            trees = {a: jax.tree.map(np.asarray, JM.init_model(
                jax.random.fold_in(key, 20 + i),
                W.serve_cfg(jsmoke, jget_config, a)))
                for i, a in enumerate((W.DENSE, W.SWA))}
            inputs = {"attn": attn, "moe": moe_in, "serve": trees,
                      "prompts": [rng.integers(1, 512, n).astype(np.int32)
                                  for n in W.SERVE_LENS]}
            torch.save(inputs, tmp / "inputs.part")
            (tmp / "inputs.part").replace(tmp / "inputs.pt")
        except BaseException:
            (tmp / "inputs.pt.failed").touch()
            raise
        single = pool.submit(_single, inputs, tmp)
        ref = {"attn": {a: _reference_attn(a, attn[a]) for a in W.ATTN},
               "moe": moe_ref,
               "jserve": {a: _reference_server(a, trees[a],
                                               inputs["prompts"])
                          for a in (W.DENSE, W.SWA)},
               "single": single.result()}
        world_run.result()
    payloads = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(W.RANKS)]
    return tmp, inputs, payloads, ref


def _blocks(p, b):
    """(this rank's rows of a b-row batch, its head_dim block of 16)."""
    d, m = p["coords"]["data"], p["coords"]["model"]
    rows, hd = b // D_RANKS, 16 // M_RANKS
    return slice(d * rows, (d + 1) * rows), slice(m * hd, (m + 1) * hd)


ATTN_CASES = [(W.DENSE, c) for c in ("prefill", "decode", "paged_decode",
                                     "chunk", "paged_chunk")] \
    + [(W.SWA, c) for c in ("prefill", "ring")]


@pytest.mark.parametrize("arch,case", ATTN_CASES,
                         ids=[f"{a}-{c}" for a, c in ATTN_CASES])
def test_attention_matches_reference(world, arch, case):
    _, inputs, payloads, ref = world
    want = ref["attn"][arch][case]
    b = inputs["attn"][arch]["x"].shape[0]
    for p in payloads:
        rows, _ = _blocks(p, b)
        got = p["attn"][arch][case]["out"]
        w = want["out"][rows] if case == "prefill" else want["out"][:, rows]
        _close(got, w, 3e-5, f"{arch} {case}")


@pytest.mark.parametrize("arch,case", ATTN_CASES,
                         ids=[f"{a}-{c}" for a, c in ATTN_CASES])
def test_attention_cache_shards_are_the_reference_cache_sliced(
        world, arch, case):
    """Each rank holds its rows and its head_dim block of every kv head
    (``cache_pspecs``); a paged rank the pool whole over pages, of which
    its own slots' pages hold the reference's values."""
    _, inputs, payloads, ref = world
    want = ref["attn"][arch][case]["cache"]
    b = inputs["attn"][arch]["x"].shape[0]
    bt = np.asarray(W.BLOCK_TABLE)
    for p in payloads:
        rows, dims = _blocks(p, b)
        got = p["attn"][arch][case]["cache"]
        for k in ("k", "v"):
            if "block_table" in want:
                pages = bt[rows][bt[rows] >= 0]
                np.testing.assert_array_equal(got["block_table"], bt[rows])
                _close(got[k][pages], want[k][pages][..., dims], 3e-5, k)
                assert got[k].shape[0] == want[k].shape[0] + 1  # trash page
            else:
                _close(got[k], want[k][rows][..., dims], 3e-5, k)
        if case != "prefill":
            np.testing.assert_array_equal(got["pos"], want["pos"][rows])


@pytest.mark.parametrize("arch", list(W.ATTN))
def test_attention_gradients_match_single_device(world, arch):
    _, _, payloads, ref = world
    want = ref["single"]["grads"][arch]
    for p in payloads:
        got = p["attn"][arch]["prefill"]["grads"]
        assert {k for k in got if k != "x_local"} == want.keys()
        for k, v in want.items():
            _close(got[k], v, 1e-4, f"{arch} grad {k}")


def test_attention_exchange_is_chosen_by_its_bytes(world):
    """Decode (one query a slot) exchanges partial scores: a reduce-
    scatter and the q and output all-to-alls; a chunk of 8 gathers the
    rank's kv head (two all-to-alls, no reduce-scatter), which moves fewer
    bytes from 8 queries a slot on at these widths."""
    _, _, payloads, _ = world
    assert TL._scores_cheaper(1, 40, 1, 16, 4, 4)
    assert not TL._scores_cheaper(8, 40, 1, 16, 4, 4)
    for p in payloads:
        for arch, case in ATTN_CASES[1:]:
            if case == "prefill":
                continue
            c = p["attn"][arch][case]["counts"]
            if "chunk" in case:
                assert c["reduce_scatter"] == 0 and c["all_to_all"] == 2
            else:
                steps = W.RING["steps"] if case == "ring" else 1
                assert c["reduce_scatter"] == steps
                assert c["all_to_all"] == 2 * steps
            n = W.RING["steps"] if case == "ring" else 1
            assert c["gather_for_split"] == c["all_reduce"] == n


MOE_IDS = [(e, c) for e in W.MOE_EXPERTS for c in W.MOE_CASES]


@pytest.mark.parametrize("e,case", MOE_IDS,
                         ids=[f"E{e}-{c}" for e, c in MOE_IDS])
def test_tp_in_expert_matches_reference(world, e, case):
    _, _, payloads, ref = world
    want = ref["moe"][e, case]
    dropped = int((~want["kept"]).sum())
    assert dropped > 0, "the capacity drops choices"
    for p in payloads:
        got = p["moe"][e, case]
        _close(got["y"], want["y"], 3e-5, "moe output")
        _close(got["aux"], want["aux"], 3e-5, "aux loss")
        np.testing.assert_array_equal(got["gate_idx"], want["gate_idx"])
        np.testing.assert_array_equal(got["kept"], want["kept"])
        assert got["dropped"] == (dropped, want["kept"].size)
        # the unshard, the counts' gather, the partial outputs' sum over
        # "model" and the probabilities' over "data"
        assert got["counts"]["all_reduce"] == 2, got["counts"]


@pytest.mark.parametrize("e,case", MOE_IDS,
                         ids=[f"E{e}-{c}" for e, c in MOE_IDS])
def test_tp_in_expert_gradients_match_reference(world, e, case):
    _, _, payloads, ref = world
    want = ref["moe"][e, case]["grads"]
    for p in payloads:
        got = p["moe"][e, case]["grads"]
        assert {k for k in got if k != "x_local"} == want.keys()
        for k, v in want.items():
            _close(got[k], v, 1e-4, f"grad {k}")


SERVE_KEYS = [(W.DENSE, be, pg) for be, pg in W.SERVE_RUNS] \
    + [(W.SWA, "pallas", 0)]


@pytest.mark.parametrize("key", SERVE_KEYS,
                         ids=[f"{a}-{b}-page{p}" for a, b, p in SERVE_KEYS])
def test_mesh_server_matches_single_device_and_reference(world, key):
    _, _, payloads, ref = world
    single = ref["single"]["serve"][key]
    assert single["done"]
    assert single["tokens"] == ref["jserve"][key[0]]
    for p in payloads:
        got = p["serve"][key]
        assert got["done"] and got["tokens"] == single["tokens"]
        assert got["ttft"] == single["ttft"]
        assert got["tick_log"] == single["tick_log"]
        assert got["stats"] == single["stats"]
        assert got["counts"]["reduce_scatter"] > 0     # scores exchanged


def test_paged_equals_dense_and_fused_equals_unfused_on_the_mesh(world):
    _, _, payloads, _ = world
    for p in payloads:
        runs = {k[1:]: v for k, v in p["serve"].items() if k[0] == W.DENSE}
        want = runs["pallas", 0]
        assert want["stats"]["prefill_ticks"] > 0
        for k, v in runs.items():
            assert v["tokens"] == want["tokens"], k
            assert v["tick_log"] == want["tick_log"], k
        for page in (0, 4):
            assert runs["pallas_fused", page]["stats"] == \
                runs["pallas", page]["stats"]


def test_ranks_agree_bitwise(world):
    """Every rank of a data shard holds the same attention and MoE
    outputs and input gradients; every rank the same server and trainer
    results."""
    _, _, payloads, _ = world
    first = {}
    for p in payloads:
        f = first.setdefault(p["coords"]["data"], p)
        for arch, case in ATTN_CASES:
            assert p["attn"][arch][case]["out"].tobytes() == \
                f["attn"][arch][case]["out"].tobytes(), (arch, case)
        for arch in W.ATTN:
            assert p["attn"][arch]["prefill"]["grads"]["x_local"].tobytes() \
                == f["attn"][arch]["prefill"]["grads"]["x_local"].tobytes()
        for key in MOE_IDS:
            for k in ("y_local", "aux"):
                assert p["moe"][key][k].tobytes() == \
                    f["moe"][key][k].tobytes(), (key, k)
            assert p["moe"][key]["grads"]["x_local"].tobytes() == \
                f["moe"][key]["grads"]["x_local"].tobytes()
    p0 = payloads[0]
    for p in payloads[1:]:
        for key in SERVE_KEYS:
            assert p["serve"][key]["tokens"] == p0["serve"][key]["tokens"]
        for arch in (W.DENSE, W.SWA):
            loss = lambda h: [(r["loss"], r["grad_norm"]) for r in h]
            assert loss(p["train"][arch]["history"]) == \
                loss(p0["train"][arch]["history"])
            for k, v in p["train"][arch]["params"].items():
                assert v.tobytes() == \
                    p0["train"][arch]["params"][k].tobytes(), k


@pytest.mark.parametrize("arch", [W.DENSE, W.SWA])
def test_mesh_trainer_matches_single_device(world, arch):
    _, _, payloads, ref = world
    want = ref["single"]["train"][arch]
    got = payloads[0]["train"][arch]
    assert [h["step"] for h in got["history"]] == [1, 2]
    for g, w in zip(got["history"], want["history"]):
        assert abs(g["loss"] - w["loss"]) <= 1e-4, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * max(
            1.0, w["grad_norm"])
    assert got["params"].keys() == want["params"].keys()
    for k, v in want["params"].items():
        _close(got["params"][k], v, 1e-4, k)


@pytest.mark.parametrize("arch", [W.DENSE, W.SWA])
def test_mesh_checkpoint_restores_on_one_device(world, arch):
    tmp, _, payloads, _ = world
    cfg = W.train_cfg(smoke_config, get_config, arch)
    state, at = ckpt.restore_train_state(str(tmp / f"ckpt_{arch}"), cfg,
                                         device="cpu")
    assert at == W.TRAIN["steps"]
    want = payloads[0]["train"][arch]["params"]
    got = W.gathered_params(state)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
