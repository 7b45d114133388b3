"""One rank of the 8-rank gloo world of tests/test_torch_sharded_dispatch.py
(a (4, 2) ("data", "model") mesh on the CPU), and the serving cases that
the test and the ranks share.  Imports torch and the port only: every
rank is a fresh process, and the reference stays in the parent.

Each rank runs every case and saves one payload, ``rank<r>.pt``:
``mcma_dispatch_sharded`` on the given inputs for each backend and case,
and a mesh ``DecodeServer`` for each serving case (tokens, drain stats,
tick log, the collectives counted).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

MESH = (4, 2)
BACKENDS = ("xla", "pallas", "pallas_fused")
DISPATCH_CASES = ("bare", "mask", "tiers", "residency", "all")
NO_CLIP = {"exact_frac": 1.0, "invoke_frac": 1.0}
# the serving cases: approx overrides, library size, the stream, and the
# ServeOptions (a "library" tuple and an "autotune" list of operating
# points are built with each package's own classes)
SERVERS = {
    # the reference's own mesh-server case (tests/test_sharded_dispatch.py)
    "layer": dict(approx={}, library=0, stream="one",
                  options=dict(batch=4, max_len=64, use_mcma_dispatch=True)),
    # the scheduler: tick scope, chunked prefill, the paged cache
    "tick": dict(approx=NO_CLIP, library=0, stream="six",
                 options=dict(batch=4, max_len=64, use_mcma_dispatch=True,
                              route_scope="tick", prefill_chunk=64,
                              kv_page_size=16)),
    # QoS tiers, a library of 6 (3 resident), autotune over no-clip rungs
    "qos_library_autotune": dict(
        approx=NO_CLIP, library=6, stream="six",
        options=dict(batch=4, max_len=64, use_mcma_dispatch=True,
                     route_scope="tick", prefill_chunk=64, kv_page_size=16,
                     qos_tiers=True, library=(6, 3, 2, 2),
                     autotune=[(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])),
    # the same at the default capacities and the default ladder: mesh
    # drops are per shard, so only the ranks are held to each other
    "default_ladder": dict(
        approx={}, library=6, stream="six",
        options=dict(batch=4, max_len=64, use_mcma_dispatch=True,
                     route_scope="tick", prefill_chunk=64, kv_page_size=16,
                     qos_tiers=True, library=(6, 3, 2, 2), autotune=True)),
}


def stream(name: str) -> list:
    """[(prompt, max_new)]: "one" is the reference test's single request,
    "six" six requests of 5 to 40 prompt tokens (batch 4, so admission
    recycles slots across the data shards)."""
    if name == "one":
        return [(np.arange(1, 9, dtype=np.int32), 6)]
    rng = np.random.default_rng(7)
    return [(rng.integers(1, 512, n).astype(np.int32), 6)
            for n in (5, 23, 9, 40, 14, 31)]


def server_options(name: str, opts_cls, spec_cls, point_cls, **extra):
    """The ServeOptions of serving case ``name`` in one package."""
    kw = dict(SERVERS[name]["options"], **extra)
    if "library" in kw:
        lib, res, win, cool = kw["library"]
        kw["library"] = spec_cls(library_size=lib, n_resident=res,
                                 observe_window=win, cooldown=cool)
    if isinstance(kw.get("autotune"), list):
        kw["autotune"] = tuple(point_cls(*p) for p in kw["autotune"])
    return opts_cls(**kw)


def serve(name: str, cfg, params, server_cls, req_cls, opts_cls, spec_cls,
          point_cls, **extra):
    """Run serving case ``name``: (tokens per request, aborted flags,
    drain stats as a dict without the wall time, tick log)."""
    srv = server_cls(cfg, params, options=server_options(
        name, opts_cls, spec_cls, point_cls, **extra))
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=m)
            for i, (p, m) in enumerate(stream(SERVERS[name]["stream"]))]
    if srv.tier_bounds is not None:
        choices = list(srv.tier_bounds) + [None]
        for i, r in enumerate(reqs):
            r.error_bound = choices[i % len(choices)]
    for r in reqs:
        srv.submit(r)
    stats = _plain(srv.run_until_drained(500).asdict())
    stats.pop("wall_s")                               # a host timing
    return ([list(map(int, r.out)) for r in reqs], [r.aborted for r in reqs],
            stats, [tuple(t) for t in srv.tick_log])


def _plain(x):
    """Drain stats with numpy scalars and arrays as Python values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def port_cfg(name: str):
    """The smoke internlm2-1.8b config of serving case ``name``."""
    from repro_torch.configs.registry import get_config, smoke_config
    case = SERVERS[name]
    cfg = smoke_config(get_config("internlm2-1.8b"))
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, library_size=case["library"],
        **case["approx"]))


def port_model(cfg, state: dict):
    """A port ``Model`` on the CPU holding ``state`` ({name: ndarray})."""
    from repro_torch.models.model import Model
    model = Model(cfg, torch.device("cpu"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
    return model


def dispatch_kwargs(case: str, inp: dict) -> dict:
    """The arguments of one dispatch case beyond x and the stacks."""
    t = lambda k: torch.from_numpy(inp[k])
    kw = {}
    if case in ("mask", "all"):
        kw["row_mask"] = t("mask")
    if case in ("tiers", "all"):
        kw["tier"], kw["tier_margins"] = t("tier"), t("margins")
    if case in ("residency", "all"):
        kw["residency"] = t("residency")
        kw["weights_prepadded"] = True
    return kw


def run(rank: int, out_dir: str):
    """One rank: every dispatch case and serving case on the inputs the
    parent saved as ``inputs.pt`` in ``out_dir`` (passing them as spawn
    arguments pickles them once per rank, which is slow), one payload."""
    torch.set_num_threads(1)
    inputs = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
    from repro_torch.analysis.audit import audit_sharded
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.runtime import dispatch as D
    from repro_torch.runtime.autotune import OperatingPoint
    from repro_torch.runtime.options import LibrarySpec, ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.sharding import collectives as C

    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    try:                        # (16, 16) and (2, 16, 16) need 256 / 512
        make_production_mesh(multi_pod=rank % 2 == 1)
        refused = None
    except ValueError as e:
        refused = str(e)
    d = inputs["dispatch"]
    wi, wo = torch.from_numpy(d["wi"]), torch.from_numpy(d["wo"])
    payload = {"dispatch": {}, "servers": {}, "coords": mesh.coords,
               "production_mesh": refused}
    for case in DISPATCH_CASES:
        lib = case in ("residency", "all")
        ws = [torch.from_numpy(d[k + ("_lib" if lib else "")])
              for k in ("w1", "b1", "w2", "b2")]
        logits = torch.from_numpy(d["logits_lib" if lib else "logits"])
        for be in BACKENDS:
            y, st = D.mcma_dispatch_sharded(
                mesh, torch.from_numpy(d["x"]), logits,
                lambda ep, xb: F.silu(xb @ ep[0]) @ ep[1], (wi, wo), *ws,
                exact_cap=int(d["EC"]), invoke_cap=int(d["IC"]), backend=be,
                block_t=int(d["BLOCK"]), **dispatch_kwargs(case, d))
            payload["dispatch"][be, case] = (
                y.numpy(), {k: v.numpy() for k, v in st.items()})
    # the contract gate's audit of mcma_dispatch_sharded on this mesh
    payload["audit"] = [f.key for f in audit_sharded(mesh, BACKENDS)]
    for name in SERVERS:
        state = inputs["params_lib" if SERVERS[name]["library"]
                       else "params"]
        cfg = port_cfg(name)
        C.reset_counts()
        payload["servers"][name] = serve(
            name, cfg, port_model(cfg, state), DecodeServer, Request,
            ServeOptions, LibrarySpec, OperatingPoint, mesh=mesh) \
            + (dict(C.COUNTS),)
    torch.save(payload, f"{out_dir}/rank{rank}.pt")


# ---------------------------------------------------------------------------
# The training world of tests/test_torch_train_mesh.py: 4 ranks, the train
# step on (2, 2) and (4, 1) meshes, a Trainer checkpoint crossing meshes,
# and the int8 error-feedback all-reduce on a ("pod",) mesh.
# ---------------------------------------------------------------------------

TRAIN_RANKS = 4
TRAIN_MESHES = ((2, 2), (4, 1))
GRAD_ACCUMS = (1, 2)
TRAIN_LR = 1e-3
TRAIN_STEPS = 2
CKPT_STEPS = (2, 4)             # saved at, continued to
QUAD = dict(steps=300, lr=0.05)


def train_cfg():
    """The reference's mesh-test config (tests/test_sharding.py) with the
    ApproxFFN and the tick router at error bound 1.4 (both kinds of
    label at a random init)."""
    from repro_torch.configs.registry import get_config, smoke_config
    cfg = dataclasses.replace(smoke_config(get_config("internlm2-1.8b")),
                              d_model=64, n_heads=4, n_kv_heads=2, vocab=256)
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, route_scope="tick", error_bound=1.4))


def train_dataset():
    from repro_torch.data.pipeline import SyntheticLM
    return SyntheticLM(vocab=256, seq_len=32, global_batch=8)


def trainer_config(total: int, ckpt_dir: str = ""):
    from repro_torch.runtime.trainer import TrainerConfig
    return TrainerConfig(total_steps=total, ckpt_every=CKPT_STEPS[0],
                         ckpt_dir=ckpt_dir, base_lr=TRAIN_LR, warmup=0,
                         log_every=100)


def _whole(mesh, named, tensors):
    from repro_torch.sharding import collectives as C
    return {k: C.gather_whole(t.detach(), named[k]._pspec, mesh).numpy()
            for k, t in tensors.items()}


def _train_case(mesh, cfg, jstate, batches, ga):
    """The mesh's loss_and_grads (gradients gathered whole) on the first
    batch, then TRAIN_STEPS train steps at warmup 0: their metrics, the
    parameters gathered whole and each rank's own shards."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data.pipeline import local_batch
    from repro_torch.runtime import steps as S
    state = train_state_from_jax(cfg, jstate, device="cpu", mesh=mesh)
    named = dict(state["params"].named_parameters())
    local = [local_batch(b, mesh, ga) for b in batches]
    with S.train_mesh_context(mesh):
        loss, metrics, grads = S.loss_and_grads(cfg, state["params"],
                                                local[0], ga)
        step = S.make_train_step(cfg, grad_accum=ga, base_lr=TRAIN_LR,
                                 warmup=0, total_steps=10)
        ms = []
        for i in range(TRAIN_STEPS):
            state, m = step(state, local[i % len(local)])
            ms.append({k: v.numpy() for k, v in m.items()})
    return {"loss": loss.numpy(),
            "metrics": {k: v.numpy() for k, v in metrics.items()},
            "grads": _whole(mesh, named, grads), "steps": ms,
            "params": _whole(mesh, named, named),
            "shards": {k: (p.detach().numpy().copy(), tuple(p._pspec))
                       for k, p in named.items()}}


def _remat_case(mesh, cfg, jstate, batch):
    """``loss_and_grads`` with ``cfg.remat`` on (grad_accum 2): the loss
    and the gradients gathered whole."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data.pipeline import local_batch
    from repro_torch.runtime import steps as S
    cfg = dataclasses.replace(cfg, remat=True)
    state = train_state_from_jax(cfg, jstate, device="cpu", mesh=mesh)
    named = dict(state["params"].named_parameters())
    with S.train_mesh_context(mesh):
        loss, _, grads = S.loss_and_grads(cfg, state["params"],
                                          local_batch(batch, mesh, 2), 2)
    return {"loss": loss.numpy(), "grads": _whole(mesh, named, grads)}


def _quadratic(mesh, targets):
    """The reference's compression test (tests/test_runtime.py): each pod
    rank's gradient of |w - target_r|^2, compressed and exact."""
    from repro_torch.optim.compression import (ef_int8_allreduce_tree,
                                               init_error_feedback)
    from repro_torch.sharding import collectives as C
    tgt = torch.from_numpy(targets[mesh.index("pod")])
    w_c = torch.zeros(tgt.shape)
    w_e = torch.zeros(tgt.shape)
    err = init_error_feedback({"g": w_c})
    for _ in range(QUAD["steps"]):
        mean, err = ef_int8_allreduce_tree({"g": 2 * (w_c - tgt)}, err,
                                           "pod", mesh)
        w_c = w_c - QUAD["lr"] * mean["g"]
        w_e = w_e - QUAD["lr"] * C.all_reduce_sum(2 * (w_e - tgt), "pod",
                                                  mesh) / mesh.size("pod")
    opt = torch.from_numpy(targets.mean(0))
    return {"err_compressed": float(torch.linalg.norm(w_c - opt)),
            "err_exact": float(torch.linalg.norm(w_e - opt))}


def _wait_for_inputs(path: str, timeout_s: float = 300.0):
    """The parent's inputs, once it has written them (it starts the ranks
    first, so that their start-up overlaps its own); ``path + ".failed"``
    says it never will."""
    import os
    import time
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(path + ".failed") or time.monotonic() > deadline:
            raise RuntimeError(f"no inputs at {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def train_rank(rank: int, out_dir: str):
    """One rank of the training world, on the inputs in
    ``train_inputs.pt``; its payload to ``train_rank<r>.pt``."""
    import shutil

    from repro_torch.launch.mesh import HostMesh
    from repro_torch.optim.compression import ef_int8_allreduce_tree
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.sharding import collectives as C
    torch.set_num_threads(1)
    meshes = {shape: HostMesh(shape, ("data", "model"))
              for shape in TRAIN_MESHES}
    inp = _wait_for_inputs(f"{out_dir}/train_inputs.pt")
    cfg = train_cfg()
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in inp["batches"]]
    out = {"cases": {}}
    for shape, mesh in meshes.items():
        out.setdefault("coords", {})[shape] = mesh.coords
        for ga in GRAD_ACCUMS:
            C.reset_counts()
            out["cases"][shape, ga] = dict(
                _train_case(mesh, cfg, inp["jstate"], batches, ga),
                counts=dict(C.COUNTS))
    # remat: the recompute's collectives give the same gradients
    out["remat"] = _remat_case(meshes[2, 2], cfg, inp["jstate"], batches[0])
    # a checkpoint written on (2, 2) at step 2, continued on (4, 1) to 4
    ck, ck2 = f"{out_dir}/ckpt", f"{out_dir}/ckpt_41"
    ds = train_dataset()
    Trainer(cfg, trainer_config(CKPT_STEPS[0], ck), ds, mesh=meshes[2, 2],
            device="cpu").run()
    if rank == 0:
        shutil.copytree(ck, ck2)
    C.barrier()
    tr = Trainer(cfg, trainer_config(CKPT_STEPS[1], ck2), ds,
                 mesh=meshes[4, 1], device="cpu")
    out["resumed_from"] = tr.start_step
    out["run"] = tr.run()
    named = dict(tr.state["params"].named_parameters())
    out["resumed"] = _whole(meshes[4, 1], named, named)
    out["history"] = tr.history
    # the int8 error-feedback all-reduce on a ("pod",) mesh of the ranks
    pod = HostMesh((TRAIN_RANKS,), ("pod",))
    ef = inp["ef"]
    r = pod.index("pod")
    mean, new_e = ef_int8_allreduce_tree(
        {k: torch.from_numpy(v[r]) for k, v in ef["g"].items()},
        {k: torch.from_numpy(v[r]) for k, v in ef["e"].items()}, "pod", pod)
    out["ef"] = ({k: v.numpy() for k, v in mean.items()},
                 {k: v.numpy() for k, v in new_e.items()})
    out["quadratic"] = _quadratic(pod, inp["targets"])
    torch.save(out, f"{out_dir}/train_rank{rank}.pt")


# ---------------------------------------------------------------------------
# the dry run's small cells (tests/test_torch_launch.py): the smoke
# internlm2-1.8b with the ApproxFFN, rank 0 of a (2, 2) mesh, and its
# decode on a (1, 4) mesh (2 kv heads over 4: the head_dim-split cache),
# recorded on a fake process group (``fake=True``, its own process) and
# for real in a 4-rank gloo world (``dryrun_rank``)
# ---------------------------------------------------------------------------

# case: (kind, seq_len, global batch, mesh)
DRYRUN_SHAPES = {"train": ("train", 64, 8, (2, 2)),
                 "prefill": ("prefill", 64, 4, (2, 2)),
                 "decode": ("decode", 64, 8, (2, 2)),
                 "decode_kv_split": ("decode", 64, 8, (1, 4))}


def dryrun_cells(fake: bool) -> dict:
    """{kind: the cell's record, with ``collectives.WIRE`` as the cell
    left it under "wire"} of every small cell."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.sharding import collectives as C
    cfg = smoke_config(get_config("internlm2-1.8b"))
    out = {}
    for case, (kind, s, b, mesh) in DRYRUN_SHAPES.items():
        C.reset_counts()
        out[case] = dryrun.run_cell(
            "internlm2-1.8b", f"{kind}_smoke", "single", approx=True,
            device="cpu", cfg=cfg,
            shape=ShapeConfig(f"{kind}_smoke", kind, s, b),
            mesh_shape=mesh, fake=fake)
        out[case]["wire"] = {k: dict(v) for k, v in C.WIRE.items()}
    return out


def dryrun_fake(path: str):
    """The small cells on a fake process group in this process, to
    ``path`` (JSON)."""
    import json
    torch.set_num_threads(1)
    with open(path, "w") as f:
        json.dump(dryrun_cells(fake=True), f)


def dryrun_rank(rank: int, out_dir: str):
    """One rank of the gloo world: the small cells on real tensors; rank
    0's records to ``dryrun_gloo.json``."""
    import json
    torch.set_num_threads(1)
    out = dryrun_cells(fake=False)
    if rank == 0:
        with open(f"{out_dir}/dryrun_gloo.json", "w") as f:
            json.dump(out, f)
