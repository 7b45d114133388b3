"""Expert parallelism: the port's MoE on a (4, 2) ("data", "model") mesh
of 8 gloo ranks on the CPU (tests/_torch_moe_world.py, one world for the
module) against the reference, on moonshot-v1-16b-a3b's smoke config (4
experts, top-2: each model rank owns 2) in float32.

Held:
  * ``_moe_fwd_manual`` (through ``moe_fwd`` on the rank's rows) within
    3e-5 of the reference's ``_moe_fwd_manual`` under ``shard_map`` on 8
    fake CPU devices (the inputs of tests/test_sharding.py::
    test_moe_manual_ep_matches_reference, in a subprocess), its aux loss
    within 1e-6, at the reference test's capacity factor and at one that
    drops choices in every data shard;
  * each rank's ``gate_idx``, ``keep`` and ``slot`` equal to the
    reference's grouped ``_moe_chunked`` routing (its groups the data
    shards' tokens) restricted to the rank's experts, and the global drop
    count equal to the groups';
  * the gradients of the router, the experts and x within 1e-5 of
    ``jax.grad`` of the grouped ``_moe_chunked`` (a gradient counted once
    per model rank, or an aux term counted |model| times, fails);
  * the MoE mesh ``DecodeServer`` at capacity factor E / top_k: tokens,
    TTFT ticks and the tick log equal to the port's single-device server
    and to the reference's single-device server;
  * at the reference's capacity, a chunk + decode step on the mesh within
    3e-5 of the grouped oracle (the single device with ``scan_chunk`` a
    data shard's tokens), and ``loss_and_grads`` through the model within
    1e-5 (loss) and 1e-5 (gradients) of it;
  * mixtral's ring buffer (window 32) decoded 40 steps past the window on
    the mesh within 3e-5 of one device;
  * a checkpoint a mesh ``Trainer`` saved restores on one device, and onto
    the mesh, bitwise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_moe_world as W  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402
from repro.runtime.server import DecodeServer as JServer  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's expert-parallel MoE on 8 fake CPU devices: the inputs
# and mesh of tests/test_sharding.py::test_moe_manual_ep_matches_reference
_MANUAL = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.registry import get_config, smoke_config
    from repro.models import moe as MOE
    from repro.sharding import activations as A
    from repro.sharding import rules as R

    mesh = jax.make_mesh((4, 2), ("data", "model"))
    key = jax.random.PRNGKey(0)
    out = {}
    for cf in (%s):
        cfg = smoke_config(get_config("moonshot-v1-16b-a3b"))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        p = MOE.init_moe(key, cfg)
        x = jax.random.normal(jax.random.fold_in(key, 1),
                              (8, 16, cfg.d_model), jnp.float32) * 0.5
        pspecs, _ = R.param_pspecs(mesh, {"blocks": {"moe": p}})
        ns = jax.tree.map(lambda q: NamedSharding(mesh, q),
                          pspecs["blocks"]["moe"],
                          is_leaf=lambda q: isinstance(q, P))
        p_sh = jax.tree.map(lambda a, s: jax.device_put(a, s), p, ns)
        xs = jax.device_put(x, NamedSharding(mesh, P(("data",), None, None)))
        with mesh, A.activation_sharding(P(("data",), None, None)):
            y, aux = jax.jit(lambda p_, x_: MOE.moe_fwd(cfg, p_, x_))(p_sh,
                                                                      xs)
        out[f"y{cf}"], out[f"aux{cf}"] = np.asarray(y), np.asarray(aux)
        out[f"x{cf}"] = np.asarray(x)
    np.savez(sys.argv[1], **out)
""")


def _jcfg(cf):
    return W.moe_cfg(jsmoke, jget_config, cf)


def _tcfg(cf):
    return W.moe_cfg(smoke_config, get_config, cf)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _jax_routing(jcfg, router, xt):
    """The reference's routing lines of ``_moe_group`` on one group."""
    t = xt.shape[0]
    e, k = jcfg.moe.n_experts, jcfg.moe.top_k
    cap = min(int(jcfg.moe.capacity_factor * t * k / e) + 1, t)
    logits = jnp.dot(xt, router.astype(xt.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, -1)
    _, gate_idx = jax.lax.top_k(probs, k)
    _, e_sorted, rank, _ = JD.class_sort_ranks(gate_idx.reshape(t * k), e)
    keep, slot = JD.capacity_slots(e_sorted, rank, cap, n_local=e)
    return (np.asarray(gate_idx), np.asarray(keep), np.asarray(slot),
            np.asarray(e_sorted), cap)


def _reference_moe(cf, p, x, w):
    """The reference's grouped ``_moe_chunked`` (groups of a data shard's
    tokens): the routing of each group and ``jax.grad`` of sum(out * w)
    + aux for the parameters and x."""
    jcfg = _jcfg(cf)
    g = W.MESH[0]
    rows = x.shape[0] // g
    routing = [_jax_routing(jcfg, jnp.asarray(p["router"]),
                            jnp.asarray(x[i * rows:(i + 1) * rows]
                                        .reshape(-1, x.shape[-1])))
               for i in range(g)]
    ocfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, scan_chunk=rows * x.shape[1]))

    def loss(p_, x_):
        y, aux = JMOE._moe_chunked(ocfg, p_, x_)
        return jnp.sum(y * jnp.asarray(w)) + aux
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return routing, {"x": np.asarray(gx),
                     **{k: np.asarray(v) for k, v in gp.items()}}


def _reference_server(tree, prompts):
    jcfg = W.no_drop(W.model_cfg(jsmoke, jget_config))
    srv = JServer(jcfg, jax.tree.map(jnp.asarray, tree),
                  options=JOptions(**W.SERVE))
    reqs = [JRequest(rid=i, prompt=p.copy(), max_new=W.SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained(2000)
    return {"tokens": [list(map(int, r.out)) for r in reqs],
            "ttft": [(r.arrival_tick, r.first_token_tick) for r in reqs],
            "tick_log": [(p, n) for p, n, _ in srv.tick_log]}


def _single(inp):
    """The port on one device: the server at E / top_k, the grouped
    oracle's chunk + decode step and ``loss_and_grads``, and mixtral's
    ring."""
    cfg = W.model_cfg(smoke_config, get_config)
    b, s = W.STEP["batch"], W.STEP["seq"]
    g = W.MESH[0]
    model = W._model(W.no_drop(cfg), inp["tree"])
    out = {"serve": W.serve(W.no_drop(cfg), model, inp["prompts"])}
    out["step"] = W._step_logits(
        W.grouped(cfg, b // g * (s - 1)), model,
        torch.from_numpy(inp["step_toks"]),
        step_cfg=W.grouped(cfg, b // g)).numpy()
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in inp["train"].items()}
    loss, metrics, grads = TS.loss_and_grads(
        W.grouped(cfg, W.TRAIN["batch"] // g * W.TRAIN["seq"]), model,
        batch)
    out["train"] = {"loss": loss.numpy(), "aux": metrics["aux_loss"].numpy(),
                    "grads": {k: v.numpy() for k, v in grads.items()}}
    swa = W.swa_cfg(smoke_config, get_config)
    lg, pos, shape = W.ring_logits(swa, W._model(swa, inp["swa_tree"]),
                                   torch.from_numpy(inp["ring_toks"]),
                                   W.RING["max_len"])
    out["ring"] = {"logits": lg.numpy(), "pos": pos, "shape": tuple(shape)}
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
    reference on 8 fake devices in a subprocess, the reference's grouped
    MoE and single-device server, the port on one device), made while
    the ranks run."""
    tmp = tmp_path_factory.mktemp("moe_world")

    def ranks():
        spawn_world(W.run, W.RANKS, (str(tmp),),
                    init_method=f"file://{tmp}/rendezvous", exchange_mib=1)

    def manual():
        cfs = ", ".join(map(str, W.CAPACITY_FACTORS))
        r = subprocess.run(
            [sys.executable, "-c", _MANUAL % cfs, str(tmp / "manual.npz")],
            capture_output=True, text=True, timeout=600,
            env={"PYTHONPATH": os.path.join(ROOT, "src"),
                 "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr[-3000:]
        return dict(np.load(tmp / "manual.npz"))

    with ThreadPoolExecutor(4) as pool:
        world_run = pool.submit(ranks)
        man = pool.submit(manual)
        try:
            key = jax.random.PRNGKey(0)
            jcfg = _jcfg(1.25)
            p = jax.tree.map(np.asarray, JMOE.init_moe(key, jcfg))
            x = np.asarray(jax.random.normal(
                jax.random.fold_in(key, 1), (*W.X_SHAPE, jcfg.d_model),
                jnp.float32) * 0.5)
            rng = np.random.default_rng(0)
            w = rng.standard_normal(x.shape).astype(np.float32)
            mcfg = W.model_cfg(jsmoke, jget_config)
            tree = jax.tree.map(np.asarray, JM.init_model(
                jax.random.PRNGKey(1), mcfg))
            swa = W.swa_cfg(jsmoke, jget_config)
            swa_tree = jax.tree.map(np.asarray, JM.init_model(
                jax.random.PRNGKey(2), swa))
            b, s = W.STEP["batch"], W.STEP["seq"]
            toks = rng.integers(0, jcfg.vocab, (W.TRAIN["batch"],
                                                W.TRAIN["seq"] + 1))
            inputs = {
                "moe": {"params": p, "x": x, "w": w}, "tree": tree,
                "jstate": {"params": tree, "step": np.zeros((), np.int32),
                           "opt": {m: jax.tree.map(np.zeros_like, tree)
                                   for m in ("m", "v")}},
                "swa_tree": swa_tree,
                "prompts": [rng.integers(1, jcfg.vocab, n).astype(np.int32)
                            for n in W.SERVE_LENS],
                "step_toks": rng.integers(0, jcfg.vocab, (b, s))
                .astype(np.int32),
                "train": {"inputs": toks[:, :-1].astype(np.int32),
                          "labels": toks[:, 1:].astype(np.int32)},
                "ring_toks": rng.integers(0, swa.vocab, (
                    W.RING["batch"], W.RING["steps"])).astype(np.int32)}
            torch.save(inputs, tmp / "inputs.part")
            (tmp / "inputs.part").replace(tmp / "inputs.pt")
        except BaseException:
            (tmp / "inputs.pt.failed").touch()
            raise
        jserve = pool.submit(_reference_server, tree, inputs["prompts"])
        single = pool.submit(_single, inputs)
        ref = {cf: _reference_moe(cf, p, x, w) for cf in W.CAPACITY_FACTORS}
        ref = {"moe": ref, "manual": man.result(), "jserve": jserve.result(),
               "single": single.result()}
        world_run.result()
    payloads = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(W.RANKS)]
    return tmp, inputs, payloads, ref


@pytest.mark.parametrize("cf", W.CAPACITY_FACTORS)
def test_moe_fwd_manual_matches_reference(world, cf):
    _, inputs, payloads, ref = world
    man = ref["manual"]
    np.testing.assert_array_equal(man[f"x{cf}"], inputs["moe"]["x"])
    for p in payloads:
        got = p["moe"][cf]
        _close(got["y"], man[f"y{cf}"], 3e-5, "moe output")
        _close(got["aux"], man[f"aux{cf}"], 1e-6, "aux loss")
        # the sharded path ran: the FSDP unshard and the router's gather,
        # the partial outputs' sum over "model", the aux over "data"
        assert got["counts"]["all_gather"] == 2, got["counts"]
        assert got["counts"]["all_reduce"] == 2, got["counts"]


@pytest.mark.parametrize("cf", W.CAPACITY_FACTORS)
def test_mesh_routing_matches_grouped_reference(world, cf):
    """Each rank's routing is its data shard's group's, restricted to the
    rank's experts: ``gate_idx`` whole, ``keep`` where the pair's expert
    is the rank's, ``slot`` shifted by the rank's first expert."""
    _, _, payloads, ref = world
    e_loc = _tcfg(cf).moe.n_experts // W.MESH[1]
    routing, _ = ref["moe"][cf]
    dropped = 0
    for p in payloads:
        got = p["moe"][cf]
        d, m = p["coords"]["data"], p["coords"]["model"]
        gate_idx, keep, slot, e_sorted, cap = routing[d]
        off = m * e_loc
        local = (e_sorted >= off) & (e_sorted < off + e_loc)
        assert got["cap"] == cap
        np.testing.assert_array_equal(got["routing"]["gate_idx"], gate_idx)
        np.testing.assert_array_equal(got["routing"]["keep"], keep & local)
        np.testing.assert_array_equal(
            got["routing"]["slot"],
            np.where(keep & local, slot - off * cap, e_loc * cap))
    dropped = sum(int((~r[1]).sum()) for r in routing)
    total = sum(r[1].size for r in routing)
    for p in payloads:
        assert p["moe"][cf]["dropped"] == (dropped, total)
    if cf < 1.0:
        assert all((~r[1]).any() for r in routing), \
            "every data shard drops choices at this capacity"


@pytest.mark.parametrize("cf", W.CAPACITY_FACTORS)
def test_mesh_gradients_match_grouped_reference(world, cf):
    """The router's, the experts' and x's gradients of sum(out * w) + aux:
    the partial gradients of each model rank's pairs summed once over
    "model", the aux term once."""
    _, _, payloads, ref = world
    _, want = ref["moe"][cf]
    for p in payloads:
        got = p["moe"][cf]["grads"]
        assert {k for k in got if k != "x_local"} == want.keys()
        for k, v in want.items():
            _close(got[k], v, 1e-5, f"grad {k}")


def test_ranks_agree_bitwise(world):
    """Every rank of a data shard holds the same output and the same
    gradient of its rows; every rank the same gathered results."""
    _, _, payloads, _ = world
    for cf in W.CAPACITY_FACTORS:
        by_shard = {}
        for p in payloads:
            got = p["moe"][cf]
            first = by_shard.setdefault(p["coords"]["data"], got)
            assert got["y_local"].tobytes() == first["y_local"].tobytes()
            assert got["grads"]["x_local"].tobytes() == \
                first["grads"]["x_local"].tobytes()
            assert got["aux"].tobytes() == \
                payloads[0]["moe"][cf]["aux"].tobytes()
    for p in payloads[1:]:
        assert p["serve"]["tokens"] == payloads[0]["serve"]["tokens"]
        assert p["step"].tobytes() == payloads[0]["step"].tobytes()
        assert p["ring"]["logits"].tobytes() == \
            payloads[0]["ring"]["logits"].tobytes()
        assert p["train"]["history"] == payloads[0]["train"]["history"]


def test_moe_mesh_server_matches_single_device_and_reference(world):
    """At capacity factor E / top_k (no choice competes for a slot) the
    mesh server's tokens, TTFT ticks and tick log equal the port's
    single-device server's and the reference's."""
    _, _, payloads, ref = world
    single, jserve = ref["single"]["serve"], ref["jserve"]
    assert single["tokens"] == jserve["tokens"]
    assert single["ttft"] == jserve["ttft"]
    assert [(p, n) for p, n, _ in single["tick_log"]] == jserve["tick_log"]
    for p in payloads:
        got = p["serve"]
        assert got["done"] and got["tokens"] == single["tokens"]
        assert got["ttft"] == single["ttft"]
        assert got["tick_log"] == single["tick_log"]
        for k in ("ticks", "prefill_ticks", "prefill_tokens", "page_hwm",
                  "pages_in_use", "undrained_queued", "undrained_inflight"):
            assert got["stats"][k] == single["stats"][k], k
        assert got["stats"]["prefill_ticks"] > 0
        assert got["counts"]["all_reduce"] and got["counts"]["all_gather"]


def test_mesh_decode_matches_grouped_oracle(world):
    """At the reference's capacity (per data shard): a chunk and a decode
    step on the mesh within 3e-5 of the single device with
    ``scan_chunk`` a data shard's tokens."""
    _, _, payloads, ref = world
    for p in payloads:
        _close(p["step"], ref["single"]["step"], 3e-5, "decode logits")


def test_mesh_loss_and_grads_match_grouped_oracle(world):
    """``loss_and_grads`` through the model on the mesh, from the
    reference's train state loaded as shards (``train_state_from_jax(
    mesh=)``; the aux loss the data shards' mean, the same on every rank)
    against the grouped oracle's on one device; the global norm over the
    expert shards (``clip_by_global_norm(mesh=)``) against its norm."""
    _, _, payloads, ref = world
    want = ref["single"]["train"]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in want["grads"].values()))
    for p in payloads:
        got = p["train"]
        _close(got["loss"], want["loss"], 1e-5, "loss")
        _close(got["aux"], want["aux"], 1e-6, "aux")
        np.testing.assert_allclose(got["norm"], norm, rtol=1e-5)
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in got["grads"].items():
            _close(g, want["grads"][k], 1e-5, f"grad {k}")


def test_mixtral_ring_past_the_window_on_a_mesh(world):
    """mixtral's smoke config (window 32, 2 kv heads) decoded 40 steps
    from an empty ring on the mesh: each rank's ring holds its rows and
    its kv head, and every step's logits are within 3e-5 of one
    device's."""
    _, _, payloads, ref = world
    single = ref["single"]["ring"]
    assert single["shape"][2] == 32 and W.RING["steps"] > 32
    for p in payloads:
        got = p["ring"]
        assert got["pos"] == single["pos"] == [W.RING["steps"]] * \
            W.RING["batch"]
        assert got["shape"] == (single["shape"][0],
                                single["shape"][1] // W.MESH[0], 32,
                                single["shape"][3] // W.MESH[1],
                                single["shape"][4])
        _close(got["logits"], single["logits"], 3e-5, "ring logits")


def test_mesh_checkpoint_restores_on_one_device_and_the_mesh(world):
    """The checkpoint a Trainer saved on the mesh at its last step: one
    device restores the state the mesh held, bitwise, and so does the
    mesh (each rank its own shards)."""
    tmp, _, payloads, _ = world
    cfg = W.model_cfg(smoke_config, get_config)
    state, at = ckpt.restore_train_state(str(tmp / "ckpt"), cfg,
                                         device="cpu")
    assert at == W.TRAIN["steps"]
    want = payloads[0]["train"]["state"]
    for k, v in state["params"].named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      want["params"][k], err_msg=k)
    for m in ("m", "v"):
        for k, v in state["opt"][m].items():
            np.testing.assert_array_equal(v.numpy(), want[m][k],
                                          err_msg=f"{m} {k}")
    assert all(p["train"]["restored_on_mesh"] for p in payloads)
    assert [h["step"] for h in payloads[0]["train"]["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"])
               for h in payloads[0]["train"]["history"])


def test_dropped_choices_counts_each_group_at_its_capacity():
    """Without a mesh ``dropped_choices`` counts ``scan_chunk``'s groups
    at their own capacities."""
    from repro_torch.models import moe
    cfg = W.grouped(_tcfg(0.5), 32)
    p = moe.MoE(cfg, "cpu", torch.Generator().manual_seed(0))
    x = torch.randn(8, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    dropped, total = moe.dropped_choices(cfg, p, x)
    want = sum(int((~moe.route(cfg, p.router, g).keep).sum())
               for g in x.reshape(4, 32, cfg.d_model))
    assert (int(dropped), int(total)) == (want, 8 * 16 * cfg.moe.top_k)
    assert 0 < want


class _Coords:
    """A duck-typed (2, 2) mesh at one rank's coordinates (what the rules
    and ``shard_tensor`` read; no process group)."""

    def __init__(self, coords):
        self.axis_names = ("data", "model")
        self.devices = np.arange(4).reshape(2, 2)
        self.coords = coords

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([2 for _ in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        i = 0
        for a in axes:
            i = i * 2 + self.coords[a]
        return i


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "internlm2-1.8b",
                                  "xlstm-1.3b"])
def test_init_model_on_a_mesh_draws_the_shards_of_the_same_values(arch):
    """``init_model(mesh=)`` cuts each parameter to the rank's block as it
    is drawn (the uncut moonshot does not fit one card four times over):
    every rank's shards are those of the whole draw, with their specs."""
    from repro_torch.models import model as TM
    from repro_torch.sharding import collectives as C
    cfg = smoke_config(get_config(arch))
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    whole = dict(TM.init_model(0, cfg, device="cpu").named_parameters())
    for coords in ({"data": 0, "model": 1}, {"data": 1, "model": 0}):
        mesh = _Coords(coords)
        shards = dict(TM.init_model(0, cfg, device="cpu",
                                    mesh=mesh).named_parameters())
        assert shards.keys() == whole.keys()
        for k, p in shards.items():
            assert torch.equal(p.data, C.shard_tensor(mesh, whole[k].data,
                                                      p._pspec)), k


def test_launchers_serve_and_train_the_moe_on_a_cpu_mesh():
    """``launch/serve.py --data/--model`` (parameters drawn as each rank's
    shards) and ``launch/train.py --mesh`` take the MoE family."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    launch_serve.main(["--arch", W.ARCH, "--smoke", "--device", "cpu",
                       "--data", "1", "--model", "2", "--batch", "2",
                       "--requests", "2", "--max-new", "3",
                       "--prefill-chunk", "4", "--kv-page-size", "4"])
    out = launch_train.main(["--arch", W.ARCH, "--smoke", "--steps", "1",
                             "--device", "cpu", "--mesh", "2,2", "--batch",
                             "4", "--seq-len", "16"])
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
