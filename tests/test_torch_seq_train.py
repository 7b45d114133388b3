"""A training microbatch below the data axes: the port on a (4, 2)
("data", "model") mesh of 8 gloo ranks on the CPU
(tests/_torch_seq_world.py, one world for the module), in float32, where
microbatches of 1 and 2 rows fall below the 4 data ranks and train split
by sequence over them (``activations.sequence_split``: every row on every
data rank, 16 of the 64 positions each), against the port on one device
and the reference's ``jax.value_and_grad`` of ``lm_loss`` on one device,
from the reference's smoke parameters converted leaf by leaf.

Held:
  * ``check_mesh_trainable`` accepts a microbatch below the data axes for
    every family wherever its sequence divides over them with each
    family's blocks dividing a rank's slice or clipped to it, and refuses
    the rest naming ROADMAP queue 3 (no world); ``local_batch`` hands
    each data rank every row and its slice of the positions;
  * ``loss_and_grads`` of internlm2 (2 kv heads over model 2, with the
    ApproxFFN and tick router; and 1 kv head, kv-split), mixtral (a
    window of 32 below S, ``scan_chunk`` groups of 32 straddling the
    data ranks, expert-parallel at 4 experts and TP-in-expert at 3),
    internvl2 (embeddings input), zamba2 (with the ApproxFFN) and the
    xLSTM (the sLSTM through its twin), at (1 row, grad_accum 1) and (2
    rows, grad_accum 2): the loss within 1e-5 and the gradients, gathered
    whole, within 1e-4 in norm of the port's single device and of the
    reference (the xLSTM's at caveat e's 2e-4); every rank's loss and
    metrics bitwise equal; remat bitwise equal to no remat;
  * the MoE's gate ids, kept flags and drops exactly one device's
    (the reference's ``_moe_chunked`` routing), outputs and aux within
    3e-5;
  * attention's q, k and v gradients within 1e-5 of one device's on every
    data slice, and an unsummed gather of k and v (``all_gather``'s
    backward) failing on an interior slice;
  * ``Trainer(mesh=)`` for two steps within tests/test_torch_train_mesh.
    py's tolerances of the port's single device, its checkpoint restoring
    on one device to the parameters the mesh held;
  * ``launch/train.py --mesh 4,2`` on the CPU at a batch below the data
    axes.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_seq_world as W  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.runtime.dispatch import capacity_slots  # noqa: E402
from repro.runtime.dispatch import class_sort_ranks  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import _split  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import MeshShape, spawn_world  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

GRAD_CASES = [(c, rows, ga) for c in W.CASES for rows, ga in W.BATCHES]
GRAD_IDS = [f"{c}-b{rows}-ga{ga}" for c, rows, ga in GRAD_CASES]
PARAM_TOL = 2 * W.TRAIN["lr"] * W.TRAIN["steps"]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _norm_close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap, scale = np.linalg.norm(got - want), max(np.linalg.norm(want), 1.0)
    assert gap <= tol * scale, f"{msg}: {gap:.3g} > {tol} x {scale:.3g}"


# ---------------------------------------------------------------------------
# the predicate and the batch (no world)
# ---------------------------------------------------------------------------

PROD = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}


def _prod_mesh(name):
    shape = PROD[name]
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return MeshShape(shape, axes)


@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_predicate_accepts_a_microbatch_below_the_data_axes(arch, mesh):
    """Every family trains one row of train_4k's 4096 positions on the
    production meshes (16 or 32 data ranks), and refuses a sequence that
    does not divide over them, naming ROADMAP queue 3."""
    cfg, m = get_config(arch), _prod_mesh(mesh)
    TM.check_mesh_trainable(cfg, m, 1, 4096)
    with pytest.raises(NotImplementedError,
                       match=r"microbatch 1 \(.*4094 positions.*"
                             r"ROADMAP queue 3"):
        TM.check_mesh_trainable(cfg, m, 1, 4094)


@pytest.mark.parametrize("case", ["internlm2", "zamba2", "xlstm"])
def test_predicate_holds_the_blocks_to_a_ranks_slice(case):
    """A rank's 24 positions (96 over 4) hold no whole number of 16-row
    query blocks or SSD / mLSTM chunks and do not clip to them: refused;
    blocks of 8 divide the slice, blocks of 32 clip to it."""
    mesh, cfg = MeshShape((4, 2)), W.cfg(smoke_config, get_config, case)
    for blk, ok in ((16, False), (8, True), (32, True)):
        c = dataclasses.replace(cfg, q_block=blk, ssm=dataclasses.replace(
            cfg.ssm, chunk=blk))
        if ok:
            TM.check_mesh_trainable(c, mesh, 2, 96)
            continue
        with pytest.raises(NotImplementedError,
                           match=r"96 positions over them with .*=16.*"
                                 r"ROADMAP queue 3"):
            TM.check_mesh_trainable(c, mesh, 2, 96)
    TM.check_mesh_trainable(cfg, mesh, 4, 90)          # the rows divide


class _DataMesh:
    """Duck-typed rank ``i`` of a ("data", "model") mesh of ``n`` data
    ranks and one model rank."""

    axis_names = ("data", "model")

    def __init__(self, n, i):
        self.n, self.i = n, i
        self.devices = np.arange(n).reshape(n, 1)

    def size(self, axes):
        return self.n if "data" in ((axes,) if isinstance(axes, str)
                                    else axes) else 1

    def index(self, axes):
        return self.i if "data" in ((axes,) if isinstance(axes, str)
                                    else axes) else 0


@pytest.mark.parametrize("rows,ga", [(1, 1), (2, 2), (3, 2), (4, 1)])
def test_local_batch_splits_the_positions_below_the_data_axes(rows, ga):
    """Below the data axes data rank i gets every row of each microbatch
    and positions [i S / 4, (i + 1) S / 4) of every leaf (an embeddings
    input too); at or above them its rows, as before."""
    from repro_torch.data.pipeline import local_batch
    rng = np.random.default_rng(0)
    b = {"inputs": torch.from_numpy(rng.standard_normal((rows * ga, 8, 3))),
         "labels": torch.from_numpy(rng.integers(0, 9, (rows * ga, 8)))}
    for i in range(4):
        got = local_batch(b, _DataMesh(4, i), ga)
        for k, v in b.items():
            mbs = v.reshape(ga, rows, *v.shape[1:])
            want = mbs[:, :, 2 * i:2 * i + 2] if rows % 4 else \
                mbs[:, i * rows // 4:(i + 1) * rows // 4]
            assert torch.equal(got[k], want.reshape(-1, *want.shape[2:]))


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _init(fn, key, jcfg):
    """The reference's ``fn(key, jcfg)`` compiled, as numpy leaves."""
    return jax.tree.map(np.asarray, jax.jit(lambda k: fn(k, jcfg))(key))


def _reference_grads(case, tree, batches):
    """The reference's ``value_and_grad`` of ``lm_loss`` on one device,
    meaned over each batch's microbatches as the train step means them,
    the gradients under the port's names."""
    jcfg = W.cfg(jsmoke, jget_config, case)
    fn = jax.jit(jax.value_and_grad(
        lambda p, i, l: JM.lm_loss(jcfg, p, i, l), has_aux=True))
    p = jax.tree.map(jnp.asarray, tree)
    out = {}
    for rows, ga in W.BATCHES:
        bt, acc, lsum = batches[case, rows, ga], None, 0.0
        for i in range(ga):
            sl = slice(i * rows, (i + 1) * rows)
            (loss, _), g = fn(p, jnp.asarray(bt["inputs"][sl]),
                              jnp.asarray(bt["labels"][sl]))
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
            lsum += float(loss)
        grads = jax.tree.map(lambda a: np.asarray(a / ga), acc)
        out[rows, ga] = {"loss": lsum / ga,
                         "grads": {k: v.numpy() for k, v in _split(
                             W._port_cfg(case), grads).items()}}
    return out


def _reference_moe(case, tree, x):
    """The reference's ``_moe_chunked`` on the whole x, with each (token,
    choice)'s expert and kept flag from its group's routing."""
    jcfg = W.cfg(jsmoke, jget_config, case)
    y, aux = jax.jit(lambda p_, x_: JMOE._moe_chunked(jcfg, p_, x_))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    b, s, _ = x.shape
    t, k, e = b * s, jcfg.moe.top_k, jcfg.moe.n_experts
    ck = jcfg.moe.scan_chunk
    g = ck if t > ck and t % ck == 0 else t
    cap = min(int(jcfg.moe.capacity_factor * g * k / e) + 1, g)
    kept, gate_idx = [], []
    for xg in x.reshape(t // g, g, -1):
        probs = jax.nn.softmax(jnp.dot(jnp.asarray(xg), jnp.asarray(
            tree["router"])).astype(jnp.float32), -1)
        _, idx = jax.lax.top_k(probs, k)
        order, e_sorted, rank, _ = class_sort_ranks(idx.reshape(-1), e)
        keep, _ = capacity_slots(e_sorted, rank, cap, n_local=e)
        flat = np.zeros(g * k, bool)
        flat[np.asarray(order)] = np.asarray(keep)
        kept.append(flat.reshape(g, k))
        gate_idx.append(np.asarray(idx))
    return {"y": np.asarray(y), "aux": np.asarray(aux),
            "kept": np.concatenate(kept).reshape(b, s, k),
            "gate_idx": np.concatenate(gate_idx).reshape(b, s, k)}


def _single(inputs, tmp):
    """The port on one device: every grads case, attention, the
    trainer."""
    out = {"grads": {}}
    for case, rows, ga in GRAD_CASES:
        out["grads"][case, rows, ga] = W.grads_case(
            W._port_cfg(case), inputs["trees"][case],
            inputs["batches"][case, rows, ga], rows, ga)
    out["attn"] = W.attention_single(inputs["attn"])
    tr = W.trainer(W._port_cfg("internlm2"), str(tmp / "single_ckpt"))
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
    reference's gradients and MoE routing, the port on one device), made
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("seq_world")

    def ranks():
        spawn_world(W.run, W.RANKS, (str(tmp),),
                    init_method=f"file://{tmp}/rendezvous", exchange_mib=1)

    with ThreadPoolExecutor(4) as pool:
        world_run = pool.submit(ranks)
        try:
            rng = np.random.default_rng(0)
            key = jax.random.PRNGKey(0)
            trees, moe_trees, batches = {}, {}, {}
            for i, case in enumerate(W.CASES):
                jcfg = W.cfg(jsmoke, jget_config, case)
                trees[case] = _init(JM.init_model,
                                    jax.random.fold_in(key, i), jcfg)
                for j, (rows, ga) in enumerate(W.BATCHES):
                    batches[case, rows, ga] = W.batch(jcfg, rows * ga,
                                                      10 * i + j)
                if jcfg.moe.n_experts:
                    moe_trees[case] = _init(
                        JMOE.init_moe, jax.random.fold_in(key, 20 + i), jcfg)
            moe_x = {(c, b): _normal(rng, b, W.SEQ, 64) * 0.5
                     for c, b in W.MOE_RUNS}
            a = W.ATTN
            attn = {t: _normal(rng, a["batch"], W.SEQ, a["heads"], a["hd"])
                    for t in ("q", "k", "v", "w")}
            inputs = {"trees": trees, "batches": batches,
                      "moe_trees": moe_trees, "moe_x": moe_x, "attn": attn}
            torch.save(inputs, tmp / "inputs.part")
            (tmp / "inputs.part").replace(tmp / "inputs.pt")
        except BaseException:
            (tmp / "inputs.pt.failed").touch()
            raise
        single = pool.submit(_single, inputs, tmp)
        refs = {c: pool.submit(_reference_grads, c, trees[c], batches)
                for c in W.CASES}
        ref = {"jax": {c: r.result() for c, r in refs.items()},
               "moe": {(c, b): _reference_moe(c, moe_trees[c], moe_x[c, b])
                       for c, b in W.MOE_RUNS},
               "single": single.result()}
        world_run.result()
    payloads = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(W.RANKS)]
    return tmp, inputs, payloads, ref


@pytest.mark.parametrize("case,rows,ga", GRAD_CASES, ids=GRAD_IDS)
def test_grads_match_single_device_and_reference(world, case, rows, ga):
    _, _, payloads, ref = world
    got = payloads[0]["grads"][case, rows, ga]
    single = ref["single"]["grads"][case, rows, ga]
    jref = ref["jax"][case][rows, ga]
    _close(got["loss"], single["loss"], 1e-5, "loss vs single")
    _close(got["loss"], jref["loss"], 1e-5, "loss vs reference")
    tol_ref = 2e-4 if case == "xlstm" else 1e-4          # caveat e
    assert got["grads"].keys() == single["grads"].keys() \
        == jref["grads"].keys()
    for k, g in got["grads"].items():
        _norm_close(g, single["grads"][k], 1e-4, f"{k} vs single")
        _norm_close(g, jref["grads"][k], tol_ref, f"{k} vs reference")
    for k, v in single["metrics"].items():
        _close(got["metrics"][k], v, 1e-5, k)
    # the sequence split ran: the keys gathered over the data axes (the
    # backward's reduce-scatters) or the state handed over
    c = got["counts"]
    assert c["gather_for_split"] and c["reduce_scatter"] \
        and c["staged"] == 0, c


def test_every_rank_holds_the_same_loss_and_metrics(world):
    _, _, payloads, _ = world
    for key, case in payloads[0]["grads"].items():
        for p in payloads[1:]:
            other = p["grads"][key]
            assert other["loss"].tobytes() == case["loss"].tobytes(), key
            for k, v in case["metrics"].items():
                assert other["metrics"][k].tobytes() == v.tobytes(), (key, k)


@pytest.mark.parametrize("case", list(W.CASES))
def test_remat_changes_nothing(world, case):
    """Under ``cfg.remat`` each block's recompute repeats its gathers and
    its state handoff in the backward: the loss and every gradient
    bitwise those without it."""
    _, _, payloads, _ = world
    rows, ga = W.BATCHES[0]
    for p in payloads:
        plain, remat = p["grads"][case, rows, ga], p["remat"][case]
        assert remat["loss"].tobytes() == plain["loss"].tobytes()
        for k, g in plain["grads"].items():
            assert remat["grads"][k].tobytes() == g.tobytes(), k


@pytest.mark.parametrize("case,rows", W.MOE_RUNS,
                         ids=[f"{c}-b{b}" for c, b in W.MOE_RUNS])
def test_moe_routes_as_one_device(world, case, rows):
    """Each rank routes its slices of the rows within the global
    ``scan_chunk`` groups (32 tokens: two data ranks' slices of a row):
    every (token, choice)'s expert and kept flag exactly one device's,
    the drops counted once, the outputs and aux within 3e-5."""
    _, _, payloads, ref = world
    want = ref["moe"][case, rows]
    n_drop = int((~want["kept"]).sum())
    assert 0 < n_drop, "the case must drop some choices"
    for p in payloads:
        got = p["moe"][case, rows]
        np.testing.assert_array_equal(got["gate_idx"], want["gate_idx"])
        np.testing.assert_array_equal(got["kept"], want["kept"])
        assert got["dropped"] == (n_drop, want["kept"].size)
        _close(got["y"], want["y"], 3e-5, "y")
        _close(got["aux"], want["aux"], 3e-5, "aux")


def test_attention_kv_gradient_of_an_interior_slice(world):
    """Every data slice's q, k and v gradients within 1e-5 of one
    device's.  The k/v gradient of an interior slice (data rank 1: the
    later slices' queries read its keys) is wrong through an unsummed
    gather, which the check must catch."""
    _, _, payloads, ref = world
    want = ref["single"]["attn"]
    n = W.SEQ // W.MESH[0]
    for p in payloads:
        for t in "qkv":
            _close(p["attn"][t], want[t], 1e-5, t)
    wrong = payloads[W.MESH[1]]["attn_unsummed"]      # data rank 1
    assert payloads[W.MESH[1]]["coords"]["data"] == 1
    for t in "kv":
        gap = np.abs(wrong[t][:, n:2 * n] - want[t][:, n:2 * n]).max()
        assert gap > 1e-2, f"the unsummed gather's {t} gradient passed"
        _close(wrong["q"], want["q"], 1e-5, "q through the unsummed gather")


def test_trainer_on_the_mesh_matches_one_device_and_restores(world):
    """Two ``Trainer`` steps at a global batch of 2 rows (below the 4 data
    ranks): losses within 1e-5 and parameters within 2 lr steps of one
    device's (tests/test_torch_train_mesh.py's tolerances), every rank's
    history the same; the mesh's checkpoint restores on one device to the
    parameters the mesh held."""
    tmp, _, payloads, ref = world
    single = ref["single"]["train"]
    got = payloads[0]["train"]
    for a, b in zip(got["history"], single["history"]):
        assert a["step"] == b["step"]
        _close(a["loss"], b["loss"], 1e-5, "loss")
    for k, v in got["params"].items():
        _close(v, single["params"][k], PARAM_TOL, k)
    for p in payloads[1:]:
        assert [h["loss"] for h in p["train"]["history"]] == \
            [h["loss"] for h in got["history"]]
    tr = W.trainer(W._port_cfg("internlm2"), str(tmp / "ckpt"))
    assert tr.start_step == W.TRAIN["steps"]
    for k, v in W.gathered_params(tr.state).items():
        np.testing.assert_array_equal(v, got["params"][k], err_msg=k)


def test_train_launcher_trains_below_the_data_axes():
    """``launch/train.py --mesh 4,2`` with 2 rows a step: every row on
    every data rank, 8 of the 32 positions each."""
    out = launch_train.main(["--smoke", "--approx", "--steps", "1",
                             "--batch", "2", "--seq-len", "32", "--device",
                             "cpu", "--mesh", "4,2"])
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
