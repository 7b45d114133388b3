"""The port's training mesh on a 4-rank gloo world on the CPU
(tests/_torch_mesh_world.py ``train_rank``), started once for the module,
with the reference's mesh-test config (tests/test_sharding.py: the smoke
internlm2-1.8b at d_model 64, 4 heads, 2 kv heads, vocab 256) and the
ApproxFFN with the tick router at error bound 1.4, from the reference's
train state converted leaf by leaf.

Held, on a (2, 2) and a (4, 1) ("data", "model") mesh with grad_accum 1
and 2 (the (4, 1) mesh isolates the data-side reduction and the
distillation's global ratio from the tensor-parallel backward):
  * ``loss_and_grads``' loss within 1e-5 and its gradients, gathered
    whole, within 1e-4 of both the port's single-device step and the
    reference's gradients on the same batch;
  * two train steps at warmup 0: ``grad_norm`` within 1e-5 relative and
    the loss within 1e-5 of the reference's ``jax.jit(make_train_step)``
    and the port's single device, and the parameters within 2 * lr *
    steps (AdamW turns near-zero gradient differences into sign flips);
  * every leaf bitwise equal on the ranks that hold the same block of
    it, and every metric bitwise equal on every rank; remat (each block
    recomputed, its collectives again, in the backward) bitwise equal to
    no remat;
  * ``Trainer(mesh=)`` saves a whole checkpoint at step 2 on (2, 2): the
    reference's ``restore`` reads it, and it continues to step 4 on one
    device and on (4, 1) within the tolerance of an uninterrupted
    single-device run;
  * ``ef_int8_allreduce_tree`` on a ("pod",) mesh of the 4 ranks against
    the reference run under ``jax.vmap(axis_name="pod")``, and the
    reference's quadratic to its bounds;
  * ``launch/train.py --mesh 2,2`` on the CPU.
"""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_mesh_world as W  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro_torch.convert import _split, train_state_from_jax  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.runtime import steps as TS  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CASES = [(shape, ga) for shape in W.TRAIN_MESHES for ga in W.GRAD_ACCUMS]
IDS = [f"{s[0]}x{s[1]}-ga{ga}" for s, ga in CASES]
PARAM_TOL = 2 * W.TRAIN_LR * W.TRAIN_STEPS


def _jcfg():
    cfg = dataclasses.replace(jsmoke(jget_config("internlm2-1.8b")),
                              d_model=64, n_heads=4, n_kv_heads=2, vocab=256)
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, route_scope="tick", error_bound=1.4))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _reference(jcfg, jstate, batches, ga, grads_fn):
    """The reference's gradients on the first batch (the microbatch
    mean) and two jitted train steps: metrics and parameters."""
    inputs, labels = batches[0]["inputs"], batches[0]["labels"]
    mb = inputs.shape[0] // ga
    acc, lsum = None, 0.0
    for i in range(ga):
        sl = slice(i * mb, (i + 1) * mb)
        (loss, _), g = grads_fn(jstate["params"], inputs[sl], labels[sl])
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        lsum += float(loss)
    grads = jax.tree.map(lambda a: np.asarray(a / ga), acc)
    step = jax.jit(JS.make_train_step(jcfg, grad_accum=ga,
                                      base_lr=W.TRAIN_LR, warmup=0,
                                      total_steps=10))
    state, ms = jstate, []
    for i in range(W.TRAIN_STEPS):
        state, m = step(state, batches[i % len(batches)])
        ms.append({k: np.asarray(v) for k, v in m.items()})
    return {"loss": lsum / ga, "grads": grads, "steps": ms,
            "params": jax.tree.map(np.asarray, state["params"])}


def _single(tcfg, jtree, batches, ga):
    """The port's single-device step on the same state and batches."""
    state = train_state_from_jax(tcfg, jtree, device="cpu")
    loss, _, grads = TS.loss_and_grads(tcfg, state["params"],
                                       _t(batches[0]), ga)
    step = TS.make_train_step(tcfg, grad_accum=ga, base_lr=W.TRAIN_LR,
                              warmup=0, total_steps=10)
    ms = []
    for i in range(W.TRAIN_STEPS):
        state, m = step(state, _t(batches[i % len(batches)]))
        ms.append({k: v.numpy() for k, v in m.items()})
    return {"loss": loss.numpy(),
            "grads": {k: g.numpy() for k, g in grads.items()}, "steps": ms,
            "params": {k: p.detach().numpy()
                       for k, p in state["params"].named_parameters()}}


def _ef_inputs():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"g": {"a": f(W.TRAIN_RANKS, 37), "b": f(W.TRAIN_RANKS, 5, 3)},
            "e": {"a": f(W.TRAIN_RANKS, 37) * 1e-2,
                  "b": f(W.TRAIN_RANKS, 5, 3) * 1e-2}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: its models are tiny, and a pool of
    threads per process only contends with the ranks and other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory, one_thread):
    """The world's payloads, its inputs, and the parent's own runs (the
    reference and the port's single device, one thread per grad_accum),
    made while the ranks run."""
    tmp = tmp_path_factory.mktemp("train_world")
    jcfg, tcfg = _jcfg(), W.train_cfg()

    def ranks():
        spawn_world(W.train_rank, W.TRAIN_RANKS, (str(tmp),),
                    init_method=f"file://{tmp}/rendezvous", exchange_mib=1)

    with ThreadPoolExecutor(1 + len(W.GRAD_ACCUMS)) as pool:
        # the ranks start up while the reference's state is made, and
        # wait for it (tests/_torch_mesh_world._wait_for_inputs)
        world_run = pool.submit(ranks)
        try:
            jstate = jax.jit(lambda k: JS.init_train_state(k, jcfg))(
                jax.random.PRNGKey(0))
            jtree = jax.tree.map(np.asarray, jstate)
            ds = W.train_dataset()
            batches = [{k: v.numpy() for k, v in ds.batch_at(i).items()}
                       for i in range(W.TRAIN_STEPS)]
            inputs = {"jstate": jtree, "batches": batches,
                      "ef": _ef_inputs(),
                      "targets": np.random.default_rng(0).standard_normal(
                          (W.TRAIN_RANKS, 8)).astype(np.float32)}
            torch.save(inputs, tmp / "train_inputs.part")
            (tmp / "train_inputs.part").replace(tmp / "train_inputs.pt")
        except BaseException:
            (tmp / "train_inputs.pt.failed").touch()
            raise
        grads_fn = jax.jit(jax.value_and_grad(
            lambda p, i, l: JM.lm_loss(jcfg, p, i, l), has_aux=True))

        def both(ga):
            return (_reference(jcfg, jstate, batches, ga, grads_fn),
                    _single(tcfg, jtree, batches, ga))
        runs = {ga: pool.submit(both, ga) for ga in W.GRAD_ACCUMS}
        ref = {"jax": {}, "single": {}}
        for ga, run in runs.items():
            ref["jax"][ga], ref["single"][ga] = run.result()
        # the uninterrupted single-device Trainer the checkpoint runs
        # are held to
        whole = Trainer(tcfg, W.trainer_config(W.CKPT_STEPS[1]), ds,
                        device="cpu")
        whole.run()
        ref["whole"] = {k: p.detach().numpy()
                        for k, p in whole.state["params"].named_parameters()}
        world_run.result()
    payloads = [torch.load(tmp / f"train_rank{r}.pt", weights_only=False)
                for r in range(W.TRAIN_RANKS)]
    return tmp, inputs, payloads, ref


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("shape,ga", CASES, ids=IDS)
def test_mesh_grads_match_single_device_and_reference(world, shape, ga):
    _, _, payloads, ref = world
    tcfg = W.train_cfg()
    case = payloads[0]["cases"][shape, ga]
    single, jref = ref["single"][ga], ref["jax"][ga]
    _close(case["loss"], single["loss"], 1e-5, "loss vs single")
    _close(case["loss"], jref["loss"], 1e-5, "loss vs reference")
    want = _split(tcfg, jref["grads"])
    assert case["grads"].keys() == single["grads"].keys() == want.keys()
    for k, g in case["grads"].items():
        assert g.shape == single["grads"][k].shape, k
        _close(g, single["grads"][k], 1e-4, f"grad {k} vs single")
        _close(g, want[k], 1e-4, f"grad {k} vs reference")
    # the sharded path ran: gathers, reduce-scatters and reductions
    counts = case["counts"]
    assert counts["all_gather"] and counts["all_reduce"]
    assert bool(counts["reduce_scatter"]) == (shape[0] > 1)
    assert counts["staged"] == 0             # CPU tensors: nothing staged


@pytest.mark.parametrize("shape,ga", CASES, ids=IDS)
def test_mesh_train_steps_match_single_device_and_reference(world, shape,
                                                            ga):
    _, _, payloads, ref = world
    tcfg = W.train_cfg()
    case = payloads[0]["cases"][shape, ga]
    single, jref = ref["single"][ga], ref["jax"][ga]
    for got, s, j in zip(case["steps"], single["steps"], jref["steps"]):
        assert got.keys() == s.keys() == j.keys()
        for other in (s, j):
            np.testing.assert_allclose(got["grad_norm"], other["grad_norm"],
                                       rtol=1e-5)
            _close(got["loss"], other["loss"], 1e-5, "loss")
            for k in got:
                _close(got[k], other[k], 1e-4, k)
    want = _split(tcfg, jref["params"])
    for k, p in case["params"].items():
        _close(p, single["params"][k], PARAM_TOL, f"{k} vs single")
        _close(p, want[k], PARAM_TOL, f"{k} vs reference")


def test_mesh_remat_changes_nothing(world):
    """Under ``cfg.remat`` each block's recompute repeats its collectives
    in the backward: the loss and every gradient bitwise those without
    it ((2, 2), grad_accum 2)."""
    _, _, payloads, _ = world
    for p in payloads:
        case, remat = p["cases"][(2, 2), 2], p["remat"]
        assert remat["loss"].tobytes() == case["loss"].tobytes()
        for k, g in case["grads"].items():
            assert remat["grads"][k].tobytes() == g.tobytes(), k


def test_replicated_leaves_and_metrics_bitwise_equal_across_ranks(world):
    """After the steps every rank holding the same block of a leaf holds
    the same bits (the replicated leaves on every rank, a model-sharded
    leaf on the ranks of its model index), and every metric is the same
    on every rank."""
    _, _, payloads, _ = world
    for (shape, ga), case in payloads[0]["cases"].items():
        for r, p in enumerate(payloads[1:], 1):
            other = p["cases"][shape, ga]
            for a, b in zip(case["steps"], other["steps"]):
                for k in a:
                    assert a[k].tobytes() == b[k].tobytes(), (shape, ga, k)
            ca, cb = payloads[0]["coords"][shape], p["coords"][shape]
            for k, (t, spec) in case["shards"].items():
                axes = {a for s in spec if s for a in
                        ((s,) if isinstance(s, str) else s)}
                if all(ca[a] == cb[a] for a in axes):
                    assert t.tobytes() == other["shards"][k][0].tobytes(), \
                        (shape, ga, r, k)


def test_mesh_checkpoint_restores_on_one_device_and_another_mesh(world):
    tmp, _, payloads, ref = world
    tcfg = W.train_cfg()
    ck = str(tmp / "ckpt")
    # the reference reads the mesh's checkpoint, in its layout
    jtree, at = jckpt.restore(ck)
    assert at == W.CKPT_STEPS[0]
    jtree_p = jax.tree.map(np.asarray, jtree["params"])
    # one device continues it
    tr = Trainer(tcfg, W.trainer_config(W.CKPT_STEPS[1], ck),
                 W.train_dataset(), device="cpu")
    assert tr.start_step == W.CKPT_STEPS[0]
    restored = {k: p.detach().numpy()
                for k, p in tr.state["params"].named_parameters()}
    for k, v in _split(tcfg, jtree_p).items():
        np.testing.assert_array_equal(v.numpy(), restored[k], err_msg=k)
    tr.run()
    tol = 2 * W.TRAIN_LR * W.CKPT_STEPS[1]
    for k, p in tr.state["params"].named_parameters():
        _close(p.detach(), ref["whole"][k], tol, f"one device {k}")
    # the (4, 1) mesh continued it too
    for p in payloads:
        assert p["resumed_from"] == W.CKPT_STEPS[0]
        assert [h["step"] for h in p["history"]] == [3, 4]
    for k, v in payloads[0]["resumed"].items():
        _close(v, ref["whole"][k], tol, f"(4, 1) {k}")


def test_trainer_history_is_the_same_on_every_rank(world):
    """``history`` (the step times are the slowest rank's) and what
    ``run()`` returns are the same on every rank."""
    _, _, payloads, _ = world
    for p in payloads[1:]:
        assert p["history"] == payloads[0]["history"]
        assert p["run"] == payloads[0]["run"]
    assert payloads[0]["run"]["steps"] == W.CKPT_STEPS[1] - W.CKPT_STEPS[0]


def test_ef_int8_allreduce_on_a_pod_mesh_matches_reference(world):
    _, inputs, payloads, _ = world
    ef = inputs["ef"]

    def one(g, e):
        return JC.ef_int8_allreduce_tree(g, e, "pod")
    jmean, jerr = jax.vmap(one, axis_name="pod")(
        jax.tree.map(jnp.asarray, ef["g"]), jax.tree.map(jnp.asarray,
                                                         ef["e"]))
    for r, p in enumerate(payloads):
        mean, new_e = p["ef"]
        for k in ef["g"]:
            _close(mean[k], np.asarray(jmean[k])[r], 1e-6, f"mean {k}")
            np.testing.assert_allclose(new_e[k], np.asarray(jerr[k])[r],
                                       rtol=1e-7, atol=1e-7, err_msg=k)
            assert mean[k].tobytes() == payloads[0]["ef"][0][k].tobytes()


def test_int8_error_feedback_converges_on_a_pod_mesh(world):
    """The reference's quadratic (tests/test_runtime.py) on a ("pod",)
    mesh of the world's 4 ranks, to its bounds."""
    _, _, payloads, _ = world
    for p in payloads:
        assert p["quadratic"] == payloads[0]["quadratic"]
    out = payloads[0]["quadratic"]
    assert out["err_exact"] < 1e-3
    assert out["err_compressed"] < 1e-2


def test_remat_recompute_runs_in_the_forward_mesh_context():
    """A checkpointed block's recompute runs on autograd's device thread
    on a GPU, which context variables do not reach: the block is bound
    to the forward's mesh context (``with_current_context``)."""
    from repro_torch.sharding import activations as A
    seen = []
    with A.activation_sharding(("data", None, None), "mesh"):
        fn = A.with_current_context(
            lambda: seen.append(A.manual_dp_context()))
    th = threading.Thread(target=fn)
    th.start()
    th.join()
    assert seen == [("mesh", ("data",))] and A.manual_dp_context() == \
        (None, ())


def test_train_launcher_trains_on_a_cpu_mesh():
    out = launch_train.main(["--smoke", "--approx", "--steps", "2",
                             "--device", "cpu", "--mesh", "2,2",
                             "--batch", "4", "--seq-len", "32"])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
