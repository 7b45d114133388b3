"""xLSTM heads below |model| and a batch below the data axes: the port on a
(2, 4) ("data", "model") mesh of 8 gloo ranks on the CPU
(tests/_torch_wide_world.py, one world for the module), in float32,
against the reference on one device and the port on one device.  The
smoke xLSTM's 4 heads equal |model| = 4, so its heads are set to 2 and to
1 (``dataclasses.replace``): 2 and 4 ranks share each head.

Held:
  * ``check_mesh_servable`` / ``check_mesh_trainable`` accept the xLSTM's
    heads below |model| where |model| is a multiple of them, serving
    accepts a batch below the data axes, training accepts a microbatch
    there whose sequence divides over them and refuses one whose
    sequence does not naming ROADMAP queue 3, and a cache whose length
    does not divide over the data axes either is refused (no world);
  * the mLSTM and sLSTM cores with heads below |model|: a prefill, a
    prefill from its state and decode steps within 3e-5 of the
    reference's single-device ``repro.models.xlstm`` (the sLSTM within
    2e-4, ROADMAP caveat e), the states too; the prefill's gradients
    within 1e-4 in norm of the port's single device; every model rank's
    states bitwise equal;
  * context-parallel attention (3 slots whole on both data ranks, the
    cache split by sequence): decode over a dense cache at and past its
    end, kv-split (smoke internlm2's 2 kv heads over 4), a chunk across
    the slices' boundary and past the end, the ring past its window and
    past its wrap (kv-split and not), each within 3e-5 of the reference's
    ``attention_fwd`` over the whole cache; each rank's cache slice equal
    to the reference's sliced (a prefill's returned k/v too); every rank's
    output bitwise equal;
  * the MoE at a batch of 1 and 3 (TP-in-expert at 2 experts,
    expert-parallel at 4): outputs and aux within 3e-5 of the reference's
    ``_moe_chunked``, ``gate_idx``, kept flags and drops exactly one
    device's;
  * the mesh ``DecodeServer`` at 1 and 3 slots on smoke zamba2 (MCMA at
    tick scope), mixtral and the xLSTM: tokens, TTFT, tick log and drain
    counters (``InvokeStats`` included) equal to the port's single device,
    tokens equal to the reference's single device, every rank's equal;
  * ``Trainer(mesh=)`` on the xLSTM for two steps: losses and parameters
    within 1e-4 of the port's single device, and its checkpoint restores
    on one device to the parameters the mesh held.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_wide_world as W  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.runtime.dispatch import capacity_slots  # noqa: E402
from repro.runtime.dispatch import class_sort_ranks  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch.mesh import MeshShape, spawn_world  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

D_RANKS, M_RANKS = W.MESH


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _norm_close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= tol * max(np.linalg.norm(want),
                                                   1.0), msg


# ---------------------------------------------------------------------------
# the predicate (no world)
# ---------------------------------------------------------------------------

def _xlstm(heads):
    return W.xlstm_cfg(smoke_config, get_config, heads)


@pytest.mark.parametrize("heads,shape", [(2, (2, 4)), (1, (2, 4)),
                                         (4, (1, 16)), (2, (1, 8))],
                         ids=["2-over-4", "1-over-4", "4-over-16",
                              "2-over-8"])
@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_predicate_accepts_xlstm_heads_below_model(heads, shape, train):
    cfg = _xlstm(heads)
    check = TM.check_mesh_trainable if train else TM.check_mesh_servable
    check(cfg, MeshShape(shape), 4 * shape[0])
    from repro_torch.models import xlstm
    assert xlstm.heads_below_model(cfg, shape[1])


@pytest.mark.parametrize("arch,batch", [(W.XL, 1), (W.HYB, 3), (W.SWA, 1)])
def test_serving_accepts_a_batch_below_the_data_axes(arch, batch):
    cfg = W.serve_cfg(smoke_config, get_config, arch)
    TM.check_mesh_servable(cfg, MeshShape((2, 4)), batch, max_len=64)
    # a microbatch there trains split by sequence over the data axes,
    # unless its sequence does not divide over them
    TM.check_mesh_trainable(cfg, MeshShape((2, 4)), 1, 64)
    with pytest.raises(NotImplementedError,
                       match="microbatch 1 .*63 positions.*ROADMAP queue 3"):
        TM.check_mesh_trainable(cfg, MeshShape((2, 4)), 1, 63)


def test_a_cache_that_divides_neither_way_is_refused():
    cfg = W.serve_cfg(smoke_config, get_config, W.HYB)
    with pytest.raises(NotImplementedError,
                       match="KV cache of 63 rows.*ROADMAP queue 3"):
        TM.check_mesh_servable(cfg, MeshShape((2, 4)), 3, max_len=63)
    TM.check_mesh_servable(cfg, MeshShape((2, 4)), 4, max_len=63)
    TM.check_mesh_servable(cfg, MeshShape((2, 4)), 3, max_len=63,
                           paged=True)


class _DataMesh:
    """Duck-typed rank ``i`` of a ("data", "model") mesh of ``n`` data
    ranks: the cache writes need only its sizes and index."""

    axis_names = ("data", "model")

    def __init__(self, n, i):
        self.n, self.i = n, i

    def size(self, axes):
        return self.n if "data" in ((axes,) if isinstance(axes, str)
                                    else axes) else 1

    def index(self, axes):
        return self.i if "data" in ((axes,) if isinstance(axes, str)
                                    else axes) else 0


WRITES = {"decode": (W.OLMO, (5, 27, 44), None),
          "ring": (W.SWA, (40, 70, 5), None),
          "chunk": (W.OLMO, W.CHUNK["pos"], W.CHUNK["n_valid"])}


@pytest.mark.parametrize("case", sorted(WRITES))
def test_sequence_split_cache_writes_are_one_devices_sliced(case):
    """A rank's slice of a cache split by sequence over 2 data ranks
    after ``_cache_write`` equals one device's cache after the same
    write, sliced, bitwise; its mask the whole mask's slice."""
    from repro_torch.models import layers as TL
    from repro_torch.sharding.activations import (activation_sharding,
                                                  whole_rows)
    from repro_torch.sharding.rules import P
    arch, pos, n_valid = WRITES[case]
    cfg = smoke_config(get_config(arch))
    rng = np.random.default_rng(7)
    rows = cfg.sliding_window or W.MAX_LEN
    s = W.CHUNK["seq"] if n_valid else 1
    shape = (len(pos), rows, cfg.n_kv_heads, cfg.hd)
    whole = {k: torch.from_numpy(_normal(rng, *shape)) for k in ("k", "v")}
    new = [torch.from_numpy(_normal(rng, len(pos), s, *shape[2:]))
           for _ in range(2)]

    def cache_of(kv):
        c = {**kv, "pos": torch.tensor(pos, dtype=torch.int32)}
        if n_valid:
            c["n_valid"] = torch.tensor(n_valid, dtype=torch.int32)
        return c
    ref = cache_of({k: v.clone() for k, v in whole.items()})
    ak, _, valid, _ = TL._cache_write(cfg, *new, ref)
    n = rows // 2
    for i in range(2):
        part = cache_of({k: v[:, i * n:(i + 1) * n].clone()
                         for k, v in whole.items()})
        with activation_sharding(P("data", None, None), _DataMesh(2, i)), \
                whole_rows():
            pk, _, pvalid, _ = TL._cache_write(cfg, *new, part)
        assert torch.equal(pk, ak[:, i * n:(i + 1) * n])
        assert torch.equal(part["v"], ref["v"][:, i * n:(i + 1) * n])
        assert torch.equal(pvalid, valid[..., i * n:(i + 1) * n])


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _init(fn, key, jcfg):
    """The reference's ``fn(key, jcfg)`` compiled (eager JAX init was the
    slow part of building the inputs), as numpy leaves."""
    return jax.tree.map(np.asarray, jax.jit(lambda k: fn(k, jcfg))(key))


def _core_inputs(rng, key, heads, core):
    jcfg = W.xlstm_cfg(jsmoke, jget_config, heads)
    init = JX.init_mlstm if core == "mlstm" else JX.init_slstm
    p = _init(init, key, jcfg)
    b, d = W.CORE["batch"], jcfg.d_model
    return {"params": p, "x": _normal(rng, b, W.CORE["seq"], d) * 0.5,
            "w": _normal(rng, b, W.CORE["seq"], d),
            "x2": _normal(rng, b, W.CORE["seq2"], d) * 0.5,
            "steps": [_normal(rng, b, 1, d) * 0.5
                      for _ in range(W.CORE["steps"])]}


def _reference_core(heads, core, inp):
    jcfg = W.xlstm_cfg(jsmoke, jget_config, heads)
    f = JX.mlstm_fwd if core == "mlstm" else JX.slstm_fwd
    fwd = jax.jit(lambda p, x, st: f(jcfg, p, x, st))
    first = jax.jit(lambda p, x: f(jcfg, p, x, None))
    p = jax.tree.map(jnp.asarray, inp["params"])
    y, st = first(p, jnp.asarray(inp["x"]))
    out = {"prefill": (y, st)}
    y, st = fwd(p, jnp.asarray(inp["x2"]), st)
    out["from_state"] = (y, st)
    for i, xs in enumerate(inp["steps"]):
        y, st = fwd(p, jnp.asarray(xs), st)
        out[f"step{i}"] = (y, st)
    return {k: {"y": np.asarray(y), "state": {n: np.asarray(v)
                                              for n, v in st.items()}}
            for k, (y, st) in out.items()}


def _attn_inputs(rng, key, case):
    jcfg = W.attn_cfg(jsmoke, jget_config, case)
    p = _init(JL.init_attn, key, jcfg)
    b, d, kvh, hd = W.ATTN_B, jcfg.d_model, jcfg.n_kv_heads, jcfg.hd
    kind = W.ATTN[case][2]
    out = {"params": p}
    if kind == "prefill":
        out["x"] = _normal(rng, b, W.PREFILL_SEQ, d) * 0.5
        return out
    rows = jcfg.sliding_window if kind == "ring" else W.MAX_LEN
    spec = {"decode": (W.DECODE["pos"], W.DECODE["steps"], 1),
            "ring": (W.RING["pos"], W.RING["steps"], 1),
            "chunk": (W.CHUNK["pos"], 1, W.CHUNK["seq"])}[kind]
    pos = np.asarray(spec[0], np.int32)
    out["cache"] = {"k": _normal(rng, b, rows, kvh, hd),
                    "v": _normal(rng, b, rows, kvh, hd), "pos": pos}
    out["steps"] = [(_normal(rng, b, spec[2], d) * 0.5,
                     (pos + j * spec[2])[:, None] + np.arange(spec[2]))
                    for j in range(spec[1])]
    if kind == "chunk":
        out["n_valid"] = np.asarray(W.CHUNK["n_valid"], np.int32)
    return out


def _reference_attn(case, inp):
    jcfg = W.attn_cfg(jsmoke, jget_config, case)
    fwd = jax.jit(lambda *a: JL.attention_fwd(jcfg, *a))
    p = jax.tree.map(jnp.asarray, inp["params"])
    if "cache" not in inp:
        s = inp["x"].shape[1]
        y, kv = fwd(p, jnp.asarray(inp["x"]), jnp.arange(s)[None])
        return {"out": np.asarray(y),
                "cache": {k: np.asarray(v) for k, v in kv.items()}}
    cache = {k: jnp.asarray(v) for k, v in inp["cache"].items()}
    ys = []
    for xs, ps in inp["steps"]:
        if "n_valid" in inp:
            cache["n_valid"] = jnp.asarray(inp["n_valid"])
        o, cache = fwd(p, jnp.asarray(xs), jnp.asarray(ps), cache)
        cache = {k: v for k, v in cache.items() if k != "n_valid"}
        ys.append(np.asarray(o))
    return {"out": np.stack(ys),
            "cache": {k: np.asarray(v) for k, v in cache.items()}}


def _moe_inputs(rng, key, e, b):
    jcfg = W.moe_cfg(jsmoke, jget_config, e)
    return {"params": _init(JMOE.init_moe, key, jcfg),
            "x": _normal(rng, b, W.MOE_SEQ, jcfg.d_model) * 0.5}


def _reference_moe(e, b, inp):
    """The reference's ``_moe_chunked`` with each (token, choice)'s kept
    flag from its group's routing."""
    jcfg = W.moe_cfg(jsmoke, jget_config, e)
    p, x = inp["params"], inp["x"]
    y, aux = jax.jit(lambda p_, x_: JMOE._moe_chunked(jcfg, p_, x_))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    t, k, ck = b * W.MOE_SEQ, jcfg.moe.top_k, W.MOE_CHUNK
    g = ck if t > ck and t % ck == 0 else t
    cap = min(int(jcfg.moe.capacity_factor * g * k / e) + 1, g)
    kept, gate_idx = [], []
    for xg in x.reshape(t // g, g, -1):
        probs = jax.nn.softmax(jnp.dot(jnp.asarray(xg), jnp.asarray(
            p["router"])).astype(jnp.float32), -1)
        _, idx = jax.lax.top_k(probs, k)
        order, e_sorted, rank, _ = class_sort_ranks(idx.reshape(-1), e)
        keep, _ = capacity_slots(e_sorted, rank, cap, n_local=e)
        flat = np.zeros(g * k, bool)
        flat[np.asarray(order)] = np.asarray(keep)
        kept.append(flat.reshape(g, k))
        gate_idx.append(np.asarray(idx))
    return {"y": np.asarray(y), "aux": np.asarray(aux),
            "kept": np.concatenate(kept),
            "gate_idx": np.concatenate(gate_idx)}


def _reference_server(arch, tree, prompts, slots):
    jcfg = W.serve_cfg(jsmoke, jget_config, arch)
    srv = JServer(jcfg, jax.tree.map(jnp.asarray, tree),
                  options=JOptions(**W.serve_options(arch, slots)))
    reqs = [JRequest(rid=i, prompt=p.copy(), max_new=W.SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained(2000)
    return [list(map(int, r.out)) for r in reqs]


def _single(inputs, tmp):
    """The port on one device: the cores (their gradients), every server
    run and the trainer."""
    out = {"core": {}, "serve": {}}
    for (h, core), inp in inputs["core"].items():
        out["core"][h, core] = W.core_case(
            W.xlstm_cfg(smoke_config, get_config, h), core, inp)
    for arch in W.SERVE_ARCHS:
        cfg = W.serve_cfg(smoke_config, get_config, arch)
        for slots in W.SERVE_SLOTS:
            out["serve"][arch, slots] = W.serve(
                cfg, W.model(cfg, inputs["serve"][arch]), inputs["prompts"],
                slots)
    tr = W.trainer(W.xlstm_cfg(smoke_config, get_config),
                   str(tmp / "single_ckpt"))
    tr.run()
    out["train"] = {"history": tr.history,
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
    reference's cores, attention, MoE and servers, the port on one
    device), made while the ranks run."""
    tmp = tmp_path_factory.mktemp("wide_world")

    def ranks():
        spawn_world(W.run, W.RANKS, (str(tmp),),
                    init_method=f"file://{tmp}/rendezvous", exchange_mib=1)

    with ThreadPoolExecutor(3) as pool:
        world_run = pool.submit(ranks)
        try:
            rng = np.random.default_rng(0)
            key = jax.random.PRNGKey(0)
            core = {(h, c): _core_inputs(rng, jax.random.fold_in(
                key, 2 * i + j), h, c)
                for i, h in enumerate(W.XL_HEADS)
                for j, c in enumerate(("mlstm", "slstm"))}
            attn = {c: _attn_inputs(rng, jax.random.fold_in(key, 10 + i), c)
                    for i, c in enumerate(W.ATTN)}
            moe_in = {(e, b): _moe_inputs(
                rng, jax.random.fold_in(key, 30 + 2 * i + j), e, b)
                for i, e in enumerate(W.MOE_EXPERTS)
                for j, b in enumerate(W.MOE_BATCHES)}
            trees = {a: _init(JM.init_model, jax.random.fold_in(key, 40 + i),
                              W.serve_cfg(jsmoke, jget_config, a))
                     for i, a in enumerate(W.SERVE_ARCHS)}
            inputs = {"core": core, "attn": attn, "moe": moe_in,
                      "serve": trees,
                      "prompts": [rng.integers(1, 512, n).astype(np.int32)
                                  for n in W.SERVE_LENS]}
            torch.save(inputs, tmp / "inputs.part")
            (tmp / "inputs.part").replace(tmp / "inputs.pt")
        except BaseException:
            (tmp / "inputs.pt.failed").touch()
            raise
        single = pool.submit(_single, inputs, tmp)
        ref = {"core": {k: _reference_core(*k, v) for k, v in core.items()},
               "attn": {c: _reference_attn(c, attn[c]) for c in W.ATTN},
               "moe": {k: _reference_moe(*k, v) for k, v in moe_in.items()},
               "jserve": {(a, n): _reference_server(a, trees[a],
                                                    inputs["prompts"], n)
                          for a in W.SERVE_ARCHS for n in W.SERVE_SLOTS},
               "single": single.result()}
        world_run.result()
    payloads = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(W.RANKS)]
    return tmp, inputs, payloads, ref


CORES = [(h, c) for h in W.XL_HEADS for c in ("mlstm", "slstm")]
RUNS = ["prefill", "from_state"] + [f"step{i}"
                                    for i in range(W.CORE["steps"])]


@pytest.mark.parametrize("heads,core", CORES,
                         ids=[f"{c}-heads{h}" for h, c in CORES])
def test_xlstm_cores_match_reference(world, heads, core):
    _, _, payloads, ref = world
    tol = 3e-5 if core == "mlstm" else 2e-4        # caveat e
    for run in RUNS:
        want = ref["core"][heads, core][run]
        for p in payloads:
            got = p["core"][heads, core][run]
            _close(got["y"], want["y"], tol, f"{core} {run} y")
            assert got["state"].keys() == want["state"].keys()
            for k, v in want["state"].items():
                _close(got["state"][k], v, tol, f"{core} {run} {k}")


@pytest.mark.parametrize("heads,core", CORES,
                         ids=[f"{c}-heads{h}" for h, c in CORES])
def test_xlstm_core_gradients_match_single_device(world, heads, core):
    _, _, payloads, ref = world
    want = ref["single"]["core"][heads, core]["grads"]
    for p in payloads:
        got = p["core"][heads, core]["grads"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            _norm_close(got[k], v, 1e-4, f"{core} grad {k}")


@pytest.mark.parametrize("heads,core", CORES,
                         ids=[f"{c}-heads{h}" for h, c in CORES])
def test_xlstm_states_are_bitwise_equal_over_model(world, heads, core):
    """The rules replicate the states over "model" (the heads do not
    divide): every model rank of a data shard holds the same bits."""
    _, _, payloads, _ = world
    by_data = {}
    for p in payloads:
        by_data.setdefault(p["coords"]["data"], []).append(p)
    for group in by_data.values():
        for run in RUNS:
            first = group[0]["core"][heads, core][run]["state_local"]
            for p in group[1:]:
                for k, v in p["core"][heads, core][run]["state_local"] \
                        .items():
                    np.testing.assert_array_equal(v, first[k])


def _seq_block(p, rows):
    n = rows // D_RANKS
    return slice(p["coords"]["data"] * n, (p["coords"]["data"] + 1) * n)


def _dims(p, cfg):
    """A rank's kv heads, or its head_dim block where ranks share one."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    m = p["coords"]["model"]
    if kv % M_RANKS == 0:
        w = kv // M_RANKS
        return (slice(m * w, (m + 1) * w), slice(None))
    w = hd // M_RANKS
    return (slice(None), slice(m * w, (m + 1) * w))


@pytest.mark.parametrize("case", list(W.ATTN))
def test_context_parallel_attention_matches_reference(world, case):
    _, _, payloads, ref = world
    want = ref["attn"][case]
    for p in payloads:
        got = p["attn"][case]["out"]
        _close(got, want["out"], 3e-5, case)
        np.testing.assert_array_equal(got, payloads[0]["attn"][case]["out"])


@pytest.mark.parametrize("case", list(W.ATTN))
def test_context_parallel_cache_slices_are_the_reference_sliced(world, case):
    """Each rank holds its slice of the sequence and its kv heads (or
    head_dim block), as ``cache_pspecs`` places a batch below the data
    axes; ``pos`` whole."""
    _, _, payloads, ref = world
    cfg = W.attn_cfg(smoke_config, get_config, case)
    want = ref["attn"][case]["cache"]
    for p in payloads:
        got = p["attn"][case]["cache"]
        heads, dims = _dims(p, cfg)
        for k in ("k", "v"):
            seq = _seq_block(p, want[k].shape[1])
            _close(got[k], want[k][:, seq, heads, dims], 3e-5, k)
        if "pos" in want:
            np.testing.assert_array_equal(got["pos"], want["pos"])


def test_context_parallel_combines_once_a_step(world):
    """Every cache case gathers its softmax parts over the data axes once
    a step (beside the weights' FSDP gather over "data"); the kv-split
    decode exchanges partial scores over "model" (a reduce-scatter and
    the weights' gather)."""
    _, _, payloads, _ = world
    for p in payloads:
        for case in ("dense", "dense_split", "ring", "ring_split"):
            c = p["attn"][case]["counts"]
            steps = W.RING["steps"] if "ring" in case \
                else W.DECODE["steps"]
            split = case.endswith("split")
            assert c["all_gather"] == steps * (3 if split else 2), case
            assert c["reduce_scatter"] == (steps if split else 0), case


MOE_IDS = [(e, b) for e in W.MOE_EXPERTS for b in W.MOE_BATCHES]


@pytest.mark.parametrize("e,b", MOE_IDS,
                         ids=[f"E{e}-batch{b}" for e, b in MOE_IDS])
def test_moe_below_the_data_axes_routes_as_one_device(world, e, b):
    _, _, payloads, ref = world
    want = ref["moe"][e, b]
    for p in payloads:
        got = p["moe"][e, b]
        _close(got["y"], want["y"], 3e-5, "moe output")
        _close(got["aux"], want["aux"], 3e-5, "aux")
        np.testing.assert_array_equal(got["gate_idx"], want["gate_idx"])
        np.testing.assert_array_equal(got["kept"], want["kept"])
        assert got["dropped"] == (int((~want["kept"]).sum()),
                                  want["kept"].size)
        np.testing.assert_array_equal(got["y"], payloads[0]["moe"][e, b]["y"])
    assert any((~ref["moe"][e_, b_]["kept"]).any() for e_, b_ in MOE_IDS)


SERVES = [(a, n) for a in W.SERVE_ARCHS for n in W.SERVE_SLOTS]


@pytest.mark.parametrize("arch,slots", SERVES,
                         ids=[f"{a}-{n}slots" for a, n in SERVES])
def test_mesh_server_matches_single_device_and_reference(world, arch,
                                                          slots):
    _, _, payloads, ref = world
    single = ref["single"]["serve"][arch, slots]
    assert single["done"]
    assert single["tokens"] == ref["jserve"][arch, slots]
    for p in payloads:
        got = p["serve"][arch, slots]
        assert got["done"]
        assert got["tokens"] == single["tokens"]
        assert got["ttft"] == single["ttft"]
        assert got["tick_log"] == single["tick_log"]
        assert got["stats"] == single["stats"]


def test_mesh_server_ranks_agree(world):
    """Every rank samples the same tokens; the model ranks of a data
    shard hold the same replicated states (the xLSTM's heads and the
    rows below the data axes)."""
    _, _, payloads, _ = world
    for key in SERVES:
        for p in payloads[1:]:
            assert p["serve"][key]["tokens"] == \
                payloads[0]["serve"][key]["tokens"]
    for p in payloads:
        for leaf, v in p["serve"][W.XL, 1]["cache"].items():
            np.testing.assert_array_equal(
                v, payloads[0]["serve"][W.XL, 1]["cache"][leaf], leaf)


def test_xlstm_trainer_matches_single_device_and_restores(world):
    tmp, _, payloads, ref = world
    single = ref["single"]["train"]
    for p in payloads:
        got = p["train"]
        for a, b in zip(got["history"], single["history"]):
            assert abs(a["loss"] - b["loss"]) <= 1e-4
        for k, v in single["params"].items():
            _close(got["params"][k], v, 1e-4, k)
    cfg = W.xlstm_cfg(smoke_config, get_config)
    state, at = ckpt.restore_train_state(str(tmp / "ckpt"), cfg,
                                         device="cpu")
    assert at == W.TRAIN["steps"]
    want = payloads[0]["train"]["params"]
    got = W.gathered_params(state)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
