"""The hybrid (zamba2-2.7b) and xLSTM (xlstm-1.3b) families on a (4, 2)
("data", "model") mesh of 8 gloo ranks on the CPU
(tests/_torch_ssm_world.py, one world for the module), tensor-parallel
over "model" by heads, against the reference on one device: the smoke
configs in float32 (zamba2: 4 attention heads, 8 Mamba2 heads; xlstm: 4
heads), the reference's inits converted into the port (the cores' with
their constant leaves perturbed, tests/test_torch_archs.perturb).  The
reference has no manual mesh code for these families (it places them
with the compiler), so its single-device functions are the oracle.

Held:
  * ``mamba_fwd`` (chunked, chunked from a state, the one-token update),
    ``mlstm_fwd`` (the same) and ``slstm_fwd`` (the scan and one step
    from a state) on each rank's rows and heads: outputs and the final
    states gathered whole within 3e-5 of the reference's functions and
    of the port's own single device;
  * their gradients (of a fixed projection of y and the states, a mean
    over the global batch) for x and every parameter: within 1e-4 of
    ``jax.grad`` of the reference and within 1e-5 of the port's single
    device (a statistic left per rank, a gradient sliced where it must be
    summed, or x and z taken as contiguous columns fail);
  * each family's decode token by token from an empty cache (the hybrid's
    shared block through the dispatch at tick scope, no capacity clips)
    within 3e-5 of the reference's and of the port's single device;
    a slot reset on the data shard that holds it, the other rows and
    shards untouched;
  * the mesh ``DecodeServer`` (the hybrid on both weight-switch
    backends): tokens, TTFT ticks, drain counters and the tick log equal
    to the port's single-device server and to the reference's;
  * the training forward's logits and ``loss_and_grads`` through the
    model within 3e-5 / 1e-5 of the port's single device (the hybrid's
    gradients within 1e-4: its f32 stack amplifies the mesh's summation
    order), the logits within 3e-5 of the reference's; a
    checkpoint a mesh ``Trainer`` saved restores on one device, and onto
    the mesh, bitwise;
  * every rank of a data shard bitwise equal, and every rank's tokens;
  * ``init_model(mesh=)`` draws the shards of the whole draw, and both
    launchers take both archs on a CPU mesh.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_ssm_world as W  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import mamba2 as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sharding import collectives as C  # noqa: E402
from test_torch_archs import perturb  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# the model's gradients on the mesh against one device: the smoke zamba2
# at its init moves by 3.7e-5 in norm under a 1e-7 relative noise on its
# parameters (its elements up to 1e-4 off on the mesh, 6e-6 in norm), so
# it is held at its gradient tolerance against the reference
# (tests/test_torch_hybrid.py); the cores hold 1e-5 above
GRAD_TOL = {W.HYBRID: 1e-4, W.XLSTM: 1e-5}


def _jcfg(arch):
    return W.model_cfg(jsmoke, jget_config, arch)


def _tcfg(arch):
    return W.model_cfg(smoke_config, get_config, arch)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


_JFWD = {"mamba": JMB.mamba_fwd, "mlstm": JX.mlstm_fwd, "slstm": JX.slstm_fwd}


def _core_inputs(rng):
    """The cores' reference leaves (perturbed) and each case's inputs."""
    key = jax.random.PRNGKey(3)
    jh, jx = _jcfg(W.HYBRID), _jcfg(W.XLSTM)
    params = {
        "mamba": jax.jit(lambda k: JMB.init_mamba(k, jh))(key),
        "mlstm": jax.jit(lambda k: JX.init_mlstm(k, jx))(key),
        "slstm": jax.jit(lambda k: JX.init_slstm(k, jx))(key)}
    params = {k: perturb({"core": jax.tree.map(np.asarray, v)}, 4)["core"]
              for k, v in params.items()}
    inp = {"params": params}
    b = W.CORE_BATCH
    for name, (core, s, with_state, grads) in W.CORES.items():
        cfg = jh if core == "mamba" else jx
        f32 = lambda *shape, sc=1.0: (rng.standard_normal(shape) * sc) \
            .astype(np.float32)
        case = {"x": f32(b, s, cfg.d_model, sc=0.5)}
        if with_state and core == "slstm":
            # a state the recurrence reaches: after 16 steps of the scan
            _, st = jax.jit(lambda p, x: JX.slstm_fwd(cfg, p, x))(
                jax.tree.map(jnp.asarray, params["slstm"]),
                jnp.asarray(f32(b, 16, cfg.d_model, sc=0.5)))
            case["state"] = {k: np.asarray(v) for k, v in st.items()}
        elif with_state:
            init = JMB.init_mamba_state(cfg, b) if core == "mamba" \
                else JX.init_mlstm_state(cfg, b)
            case["state"] = {k: f32(*v.shape, sc=0.3)
                             for k, v in init.items()}
        inp[name] = case
    return inp


def _state_like(core, x):
    """(name, zeros) of each state leaf of ``core`` at ``x``'s batch."""
    b = x.shape[0]
    if core == "mamba":
        return JMB.init_mamba_state(_jcfg(W.HYBRID), b).items()
    init = JX.init_mlstm_state if core == "mlstm" else JX.init_slstm_state
    return init(_jcfg(W.XLSTM), b).items()


def _reference_cores(inp):
    """Each core case on the reference, with ``jax.grad`` of the test's
    loss where the case takes gradients."""
    out = {}
    for name, (core, _, with_state, grads) in W.CORES.items():
        jcfg = _jcfg(W.HYBRID if core == "mamba" else W.XLSTM)
        p = jax.tree.map(jnp.asarray, inp["params"][core])
        case = inp[name]
        st0 = None if not with_state else jax.tree.map(jnp.asarray,
                                                       case["state"])
        fwd = lambda p_, x_: _JFWD[core](jcfg, p_, x_, st0)
        y, st = jax.jit(fwd)(p, jnp.asarray(case["x"]))
        out[name] = {"y": np.asarray(y),
                     "state": {k: np.asarray(v) for k, v in st.items()}}
        if grads:
            r = case["r"]

            def loss(p_, x_):
                y_, st_ = fwd(p_, x_)
                total = jnp.sum(y_ * r["y"]) / r["y"].size
                for k in ("h", "c", "n"):
                    if k in st_:
                        total = total + jnp.sum(st_[k] * r[k]) / r[k].size
                return total
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                p, jnp.asarray(case["x"]))
            out[name]["grads"] = {"x": np.asarray(gx),
                                  **{k: np.asarray(v) for k, v in gp.items()}}
    return out


def _reference_decode(arch, tree, toks):
    jcfg = _jcfg(arch)
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(JS.make_decode_step(jcfg, use_mcma_dispatch=True,
                                       route_scope="tick", backend="xla"))
    cache = JM.init_cache(jcfg, toks.shape[0], W.DECODE["max_len"])
    out = []
    for j in range(toks.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(toks[:, j:j + 1]))
        out.append(np.asarray(lg))
    return np.stack(out, 1)


def _reference_server(arch, tree, prompts):
    srv = JServer(_jcfg(arch), jax.tree.map(jnp.asarray, tree),
                  options=JOptions(**W.SERVE, backend="xla"))
    reqs = [JRequest(rid=i, prompt=p.copy(), max_new=W.SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    st = srv.run_until_drained(2000)
    return {"tokens": [list(map(int, r.out)) for r in reqs],
            "ttft": [(r.arrival_tick, r.first_token_tick) for r in reqs],
            "tick_log": [(p, n) for p, n, _ in srv.tick_log],
            "stats": {k: st[k] for k in ("ticks", "prefill_ticks",
                                         "dropped_rows", "undrained_queued",
                                         "undrained_inflight")}}


def _reference_tree(arch, seed):
    """The reference's init of ``arch`` (compiled).  Unperturbed: with
    its constant leaves perturbed the smoke zamba2's gradients move by
    1.5e-3 in norm under a 1e-7 relative noise on the parameters (3.7e-5
    at the plain init), past any gate a mesh's other summation order
    could be held to; the cores above take perturbed leaves."""
    tree = jax.jit(lambda k: JM.init_model(k, _jcfg(arch)))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, tree)


def _reference_model(arch, a):
    """The reference's decode, server and training forward's logits."""
    fwd = jax.jit(lambda p, x: JM.forward(_jcfg(arch), p, x)[0])
    return {"decode": _reference_decode(arch, a["tree"], a["toks"]),
            "serve": _reference_server(arch, a["tree"], a["prompts"]),
            "logits": np.asarray(fwd(jax.tree.map(jnp.asarray, a["tree"]),
                                     jnp.asarray(a["train"]["inputs"])))}


def _single(inputs):
    """The port on one device: every core case, each family's decode,
    servers and train case."""
    out = {"core": {}}
    for name, (core, *_) in W.CORES.items():
        out["core"][name] = W.core_case(
            name, _tcfg(W.HYBRID if core == "mamba" else W.XLSTM),
            inputs["core"])
    for arch in W.ARCHS:
        cfg, a = _tcfg(arch), inputs[arch]
        params = W.load_model(cfg, a["tree"])
        res = out[arch] = {"decode": W.decode_case(cfg, params, a["toks"])}
        for be in W.BACKENDS if arch == W.HYBRID else W.BACKENDS[:1]:
            res[be] = W.serve(cfg, params, a["prompts"], backend=be)
        res["train"] = W.train_case(cfg, a["jstate"], a["train"])
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
    reference's and the port's single device), made while the ranks
    run."""
    tmp = tmp_path_factory.mktemp("ssm_world")

    def ranks():
        spawn_world(W.run, W.RANKS, (str(tmp),),
                    init_method=f"file://{tmp}/rendezvous", exchange_mib=1)

    with ThreadPoolExecutor(6) as pool:
        world_run = pool.submit(ranks)
        try:
            trees = {arch: pool.submit(_reference_tree, arch, 10 + i)
                     for i, arch in enumerate(W.ARCHS)}
            rng = np.random.default_rng(0)
            inputs = {"core": _core_inputs(rng)}
            for name, (core, _, _, grads) in W.CORES.items():
                if grads:
                    x = inputs["core"][name]["x"]
                    inputs["core"][name]["r"] = {
                        k: rng.standard_normal(v.shape).astype(np.float32)
                        for k, v in [("y", x), *_state_like(core, x)]}
            for arch in W.ARCHS:
                jcfg, tree = _jcfg(arch), trees[arch].result()
                b, s = W.TRAIN["batch"], W.TRAIN["seq"]
                toks = rng.integers(0, jcfg.vocab, (b, s + 1))
                inputs[arch] = {
                    "tree": tree,
                    "jstate": {"params": tree, "step": np.zeros((), np.int32),
                               "opt": {m: jax.tree.map(np.zeros_like, tree)
                                       for m in ("m", "v")}},
                    "toks": rng.integers(1, jcfg.vocab, (
                        W.DECODE["batch"], W.DECODE["steps"]))
                    .astype(np.int32),
                    "prompts": [rng.integers(1, jcfg.vocab, n)
                                .astype(np.int32) for n in W.SERVE_LENS],
                    "train": {"inputs": toks[:, :-1].astype(np.int32),
                              "labels": toks[:, 1:].astype(np.int32)}}
            torch.save(inputs, tmp / "inputs.part")
            (tmp / "inputs.part").replace(tmp / "inputs.pt")
        except BaseException:
            (tmp / "inputs.pt.failed").touch()
            raise
        runs = {"single": pool.submit(_single, inputs),
                "core": pool.submit(_reference_cores, inputs["core"]),
                **{arch: pool.submit(_reference_model, arch, inputs[arch])
                   for arch in W.ARCHS}}
        ref = {k: r.result() for k, r in runs.items()}
        world_run.result()
    payloads = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(W.RANKS)]
    return tmp, inputs, payloads, ref


@pytest.mark.parametrize("name", sorted(W.CORES))
def test_core_on_mesh_matches_reference_and_single_device(world, name):
    _, _, payloads, ref = world
    core = W.CORES[name][0]
    want, single = ref["core"][name], ref["single"]["core"][name]
    for p in payloads:
        got = p["core"][name]
        _close(got["y"], want["y"], 3e-5, "y vs reference")
        _close(got["y"], single["y"], 3e-5, "y vs one device")
        assert got["state"].keys() == want["state"].keys()
        for k, v in got["state"].items():
            _close(v, want["state"][k], 3e-5, f"state {k}")
            _close(v, single["state"][k], 3e-5, f"state {k} vs one device")
    # the sharded path ran: the activations gathered for the rank's heads
    assert payloads[0]["counts"][name]["gather_for_split"] >= 1


@pytest.mark.parametrize("name", sorted(n for n, c in W.CORES.items()
                                        if c[3]))
def test_core_gradients_on_mesh(world, name):
    """Every parameter's and x's gradient: within 1e-4 of ``jax.grad`` of
    the reference, within 1e-5 of the port's single device."""
    _, _, payloads, ref = world
    want = ref["core"][name]["grads"]
    single = ref["single"]["core"][name]["grads"]
    for p in payloads:
        got = p["core"][name]["grads"]
        assert {k for k in got if k != "x_local"} == want.keys()
        for k, v in want.items():
            _close(got[k], v, 1e-4, f"grad {k} vs reference")
            _close(got[k], single[k], 1e-5, f"grad {k} vs one device")


@pytest.mark.parametrize("arch", W.ARCHS)
def test_decode_on_mesh_matches_reference_and_single_device(world, arch):
    _, _, payloads, ref = world
    single = ref["single"][arch]["decode"]
    for p in payloads:
        got = p[arch]["decode"]
        assert got["pos"] == single["pos"] == [W.DECODE["steps"]] \
            * W.DECODE["batch"]
        _close(got["logits"], ref[arch]["decode"], 3e-5, "vs reference")
        _close(got["logits"], single["logits"], 3e-5, "vs one device")


@pytest.mark.parametrize("arch", W.ARCHS)
def test_reset_slot_resets_the_data_shard_that_holds_it(world, arch):
    """``reset_slot`` on a mesh resets the global slot's row on the data
    shard that holds it (its local row), and no other row anywhere."""
    _, _, payloads, _ = world
    cfg = _tcfg(arch)
    fresh = TM.init_cache(cfg, W.DECODE["batch"], 1, device="cpu")
    rows = W.DECODE["batch"] // W.MESH[0]
    shard, row = divmod(W.DECODE["reset_slot"], rows)
    for p in payloads:
        got = p[arch]["decode"]
        assert got["before"].keys() == got["after"].keys() and got["before"]
        for k, before in got["before"].items():
            head, leaf = k.split(".")
            d = TM._batch_dim(head)
            after = got["after"][k]
            assert before.shape[d] == rows
            keep = [i for i in range(rows)
                    if p["coords"]["data"] != shard or i != row]
            np.testing.assert_array_equal(np.take(after, keep, d),
                                          np.take(before, keep, d), k)
            if p["coords"]["data"] == shard:
                fill = np.float32(fresh[head][leaf].flatten()[0].item())
                got_row = np.take(after, row, d)
                assert np.all(got_row == fill), k
                assert not np.array_equal(np.take(before, row, d),
                                          got_row), k


@pytest.mark.parametrize("arch,backend",
                         [(W.HYBRID, b) for b in W.BACKENDS]
                         + [(W.XLSTM, W.BACKENDS[0])])
def test_mesh_server_matches_single_device_and_reference(world, arch,
                                                         backend):
    """Token by token (these families prefill so): the mesh server's
    tokens, TTFT ticks, tick log and drain counters equal the port's
    single-device server's and the reference's; a recycled slot starts
    from a reset state (its tokens would differ otherwise)."""
    _, _, payloads, ref = world
    single, jserve = ref["single"][arch][backend], ref[arch]["serve"]
    assert single["tokens"] == jserve["tokens"]
    assert single["ttft"] == jserve["ttft"]
    assert [(p, n) for p, n, _ in single["tick_log"]] == jserve["tick_log"]
    for k, v in jserve["stats"].items():
        assert single["stats"][k] == v, k
    assert len(W.SERVE_LENS) > W.SERVE["batch"]      # slots are recycled
    for p in payloads:
        got = p[arch][backend]
        assert got["done"] and got["tokens"] == single["tokens"]
        assert got["ttft"] == single["ttft"]
        assert got["tick_log"] == single["tick_log"]
        for k in ("ticks", "prefill_ticks", "dropped_rows",
                  "kv_bytes_resident", "invocation_rate", "undrained_queued",
                  "undrained_inflight", "routed_per_class",
                  "dispatched_per_class"):
            assert got["stats"].get(k) == single["stats"].get(k), k
        assert got["stats"]["prefill_ticks"] == 0
        assert got["counts"]["gather_for_split"] > 0


def test_ranks_agree_bitwise(world):
    """Every rank of a data shard holds the same output of its rows;
    every rank the same gathered results, tokens and train history."""
    _, _, payloads, _ = world
    for name in W.CORES:
        by_shard = {}
        for p in payloads:
            got = p["core"][name]
            first = by_shard.setdefault(p["coords"]["data"], got)
            assert got["y_local"].tobytes() == first["y_local"].tobytes()
            if "grads" in got:
                assert got["grads"]["x_local"].tobytes() == \
                    first["grads"]["x_local"].tobytes()
    for p in payloads[1:]:
        for arch in W.ARCHS:
            assert p[arch]["decode"]["logits"].tobytes() == \
                payloads[0][arch]["decode"]["logits"].tobytes()
            for be in W.BACKENDS if arch == W.HYBRID else W.BACKENDS[:1]:
                assert p[arch][be]["tokens"] == payloads[0][arch][be]["tokens"]
            assert p[arch]["trainer"]["history"] == \
                payloads[0][arch]["trainer"]["history"]


def test_hybrid_backends_agree_on_the_mesh(world):
    _, _, payloads, _ = world
    for p in payloads:
        a, b = (p[W.HYBRID][be] for be in W.BACKENDS)
        assert a["tokens"] == b["tokens"] and a["tick_log"] == b["tick_log"]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_mesh_train_forward_and_grads_match_single_device(world, arch):
    """The training forward's logits (within 3e-5 of the reference's and
    of one device's) and
    ``loss_and_grads`` (the loss within 1e-5 of one device's, every
    gradient within ``GRAD_TOL``) on the mesh from the reference's train
    state."""
    _, _, payloads, ref = world
    want = ref["single"][arch]["train"]
    for p in payloads:
        got = p[arch]["train"]
        _close(got["logits"], ref[arch]["logits"], 3e-5, "vs reference")
        _close(got["logits"], want["logits"], 3e-5, "vs one device")
        _close(got["loss"], want["loss"], 1e-5, "loss")
        _close(got["aux"], want["aux"], 1e-5, "aux")
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in got["grads"].items():
            _close(g, want["grads"][k], GRAD_TOL[arch], f"grad {k}")


@pytest.mark.parametrize("arch", W.ARCHS)
def test_mesh_checkpoint_restores_on_one_device_and_the_mesh(world, arch):
    tmp, _, payloads, _ = world
    state, at = ckpt.restore_train_state(str(tmp / f"ckpt_{arch}"),
                                         _tcfg(arch), device="cpu")
    assert at == W.TRAIN["steps"]
    want = payloads[0][arch]["trainer"]
    for k, v in state["params"].named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), want["params"][k],
                                      err_msg=k)
    for m in ("m", "v"):
        for k, v in state["opt"][m].items():
            np.testing.assert_array_equal(v.numpy(), want[m][k],
                                          err_msg=f"{m} {k}")
    assert all(p[arch]["trainer"]["restored_on_mesh"] for p in payloads)
    assert all(np.isfinite(h["loss"]) for h in want["history"])


class _Coords:
    """A duck-typed (2, 2) mesh at one rank's coordinates (what the rules
    and ``shard_tensor`` read; no process group)."""

    def __init__(self, coords):
        self.axis_names = ("data", "model")
        self.devices = np.arange(4).reshape(2, 2)
        self.coords = coords

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return 2 ** len(axes)

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        i = 0
        for a in axes:
            i = i * 2 + self.coords[a]
        return i


def test_init_model_on_a_mesh_draws_the_shards_of_the_hybrid():
    """``init_model(mesh=)`` on the hybrid (the shared block's ApproxFFN
    and tick router included): every rank's shards are those of the
    whole draw, with their specs."""
    cfg = _tcfg(W.HYBRID)
    whole = dict(TM.init_model(0, cfg, device="cpu").named_parameters())
    for coords in ({"data": 0, "model": 1}, {"data": 1, "model": 0}):
        mesh = _Coords(coords)
        shards = dict(TM.init_model(0, cfg, device="cpu",
                                    mesh=mesh).named_parameters())
        assert shards.keys() == whole.keys()
        for k, p in shards.items():
            assert torch.equal(p.data, C.shard_tensor(mesh, whole[k].data,
                                                      p._pspec)), k


@pytest.mark.parametrize("arch", W.ARCHS)
def test_launchers_serve_and_train_on_a_cpu_mesh(arch):
    """``launch/serve.py --data/--model`` and ``launch/train.py --mesh``
    take both families."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    launch_serve.main(["--arch", arch, "--smoke", "--approx",
                       "--mcma-dispatch", "--route-scope", "tick", "--device",
                       "cpu", "--data", "1", "--model", "2", "--batch", "2",
                       "--requests", "2", "--prompt-len", "3", "--max-new",
                       "2"])
    out = launch_train.main(["--arch", arch, "--smoke", "--steps", "1",
                             "--device", "cpu", "--mesh", "1,2", "--batch",
                             "2", "--seq-len", "16"])
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
