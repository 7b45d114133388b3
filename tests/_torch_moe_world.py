"""One rank of the 8-rank gloo world of tests/test_torch_moe_mesh.py (a
(4, 2) ("data", "model") mesh on the CPU: 4 data shards, each model rank
owning half the experts), and the configs the test and the ranks share.
Imports torch and the port only: the reference stays in the parent.

Each rank runs every case on the inputs the parent saved as
``inputs.pt`` and saves one payload, ``rank<r>.pt``: the expert-parallel
MoE (forward, routing, gradients) at each capacity factor, the MoE mesh
server at capacity factor E / top_k, a chunk + decode step at the
reference's capacity, ``loss_and_grads`` through the model, mixtral's
ring buffer past its window, and a ``Trainer`` checkpoint saved on the
mesh and restored onto it.
"""
from __future__ import annotations

import dataclasses

import torch

MESH = (4, 2)
RANKS = MESH[0] * MESH[1]
ARCH = "moonshot-v1-16b-a3b"
SWA = "mixtral-8x7b"
# the inputs of tests/test_sharding.py::test_moe_manual_ep_matches_reference
# (x (8, 16, d): 2 rows, 32 tokens, a data shard) at its capacity factor,
# and at one that drops choices in every shard
CAPACITY_FACTORS = (1.25, 0.5)
X_SHAPE = (8, 16)
# the model-level cases: a (batch, seq) chunk of seq - 1 tokens then one
# decode step; the train batch; the ring's decode steps (its window 32)
STEP = dict(batch=8, seq=16)
TRAIN = dict(batch=8, seq=16, lr=1e-3, steps=2)
RING = dict(batch=4, steps=40, max_len=64)
SERVE = dict(batch=4, max_len=64, admission="fifo", use_mcma_dispatch=True,
             route_scope="tick", prefill_chunk=4, kv_page_size=4)
SERVE_LENS = (3, 9, 14, 5, 11, 6)
SERVE_NEW = 5


def moe_cfg(smoke_config, get_config, cf: float):
    """The reference test's config (moonshot's smoke: 4 experts, top-2,
    d 64, d_ff 128) at capacity factor ``cf``."""
    cfg = smoke_config(get_config(ARCH))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def model_cfg(smoke_config, get_config):
    """The model-level config: the reference test's at its capacity
    factor, MCMA dispatch on (the MoE takes the ApproxFFN's place; the
    server's ``use_mcma_dispatch`` needs it)."""
    cfg = moe_cfg(smoke_config, get_config, CAPACITY_FACTORS[0])
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))


def no_drop(cfg):
    """Capacity factor E / top_k: every choice gets a slot."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def grouped(cfg, tokens: int):
    """``moe.scan_chunk`` = ``tokens``: on one device the groups are the
    data shards' tokens (``local_rows`` is contiguous)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, scan_chunk=tokens))


def swa_cfg(smoke_config, get_config):
    """mixtral's smoke config (window 32, 4 experts, top-2) with 2 kv
    heads, so that the kv heads divide over the model axis (its smoke
    config keeps one)."""
    return no_drop(dataclasses.replace(smoke_config(get_config(SWA)),
                                       n_kv_heads=2))


def _port_cfgs():
    from repro_torch.configs.registry import get_config, smoke_config
    return smoke_config, get_config


def _moe_module(cfg, state, mesh):
    """An MoE holding ``state`` ({name: ndarray}), each parameter cut to
    this rank's block under the rules of a model's MoE leaf."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import param_pspecs
    p = moe.MoE(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    specs, _ = param_pspecs(mesh, {f"blocks.0.moe.{k}": v
                                   for k, v in p.state_dict().items()})
    for k, prm in p.named_parameters():
        prm.data = C.shard_tensor(mesh, prm.data, specs[f"blocks.0.moe.{k}"])
        prm._pspec = specs[f"blocks.0.moe.{k}"]
    return p.requires_grad_(True)


def _moe_case(mesh, cfg, inp):
    """``moe_fwd`` on the rank's rows (the expert-parallel branch): its
    output and aux, its routing, the global drop count, and the
    gradients of sum(out * w) + aux gathered whole."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import mesh_context
    from repro_torch.sharding.rules import P, dp_axes
    dp = dp_axes(mesh)
    p = _moe_module(cfg, inp["params"], mesh)
    rows = C.local_rows(mesh, dp, X_SHAPE[0])
    x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
    w = torch.from_numpy(inp["w"][rows])
    C.reset_counts()
    with mesh_context(mesh):
        y, aux = moe.moe_fwd(cfg, p, x)
        counts = dict(C.COUNTS)
        named = dict(p.named_parameters())
        grads = torch.autograd.grad((y * w).sum() + aux,
                                    [x, *named.values()])
        e_loc = cfg.moe.n_experts // mesh.size("model")
        router = C.gather_whole(p.router.detach(), p.router._pspec, mesh)
        with torch.no_grad():
            r = moe.route(cfg, router, x.detach().reshape(-1, x.shape[-1]),
                          n_local=e_loc, offset=mesh.index("model") * e_loc)
        dropped, total = moe.dropped_choices(cfg, p, x.detach())
    whole = lambda t: C.gather_whole(t.contiguous(), P(dp), mesh).numpy()
    return {"y": whole(y.detach()), "y_local": y.detach().numpy(),
            "aux": aux.detach().numpy(), "counts": counts,
            "routing": {k: getattr(r, k).numpy()
                        for k in ("gate_idx", "keep", "slot")},
            "cap": r.cap, "dropped": (int(dropped), int(total)),
            "grads": {"x": whole(grads[0]), "x_local": grads[0].numpy(),
                      **{k: C.gather_whole(g, named[k]._pspec, mesh).numpy()
                         for k, g in zip(named, grads[1:])}}}


def _model(cfg, tree, mesh=None):
    """A port ``Model`` holding the reference tree ``tree``: on ``mesh``
    this rank's shards."""
    from repro_torch.convert import params_from_jax
    from repro_torch.sharding import collectives as C
    model = params_from_jax(cfg, tree, device="cpu")
    if mesh is not None:
        C.shard_params(mesh, model)
    return model


def _step_logits(cfg, params, toks, step_cfg=None):
    """One chunk step (seq - 1 tokens) and one decode step on a dense
    cache: the decode step's logits."""
    from repro_torch.models import model as M
    b, s = toks.shape
    with torch.no_grad():
        cache = M.init_cache(cfg, b, 2 * s, device="cpu")
        cache, _ = M.decode_chunk(cfg, params, cache, toks[:, :-1],
                                  torch.full((b,), s - 1, dtype=torch.int32))
        logits, _ = M.decode(step_cfg or cfg, params, cache, toks[:, -1:])
    return logits


def ring_logits(cfg, params, toks, max_len):
    """Tokens (B, n) decoded one by one from an empty ring buffer of
    min(max_len, window) rows: each step's logits (B, n, V) and the final
    ``pos``."""
    from repro_torch.models import model as M
    b, n = toks.shape
    out = []
    with torch.no_grad():
        cache = M.init_cache(cfg, b, max_len, device="cpu")
        for j in range(n):
            lg, cache = M.decode(cfg, params, cache, toks[:, j:j + 1])
            out.append(lg)
    return torch.stack(out, 1), cache["pos"].tolist(), cache["k"].shape


def serve(cfg, params, prompts, mesh=None):
    """The scheduler's stream through a DecodeServer (on ``mesh`` when
    given): tokens, TTFT ticks, drain counters and the tick log."""
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    srv = DecodeServer(cfg, params, options=ServeOptions(**SERVE, mesh=mesh))
    reqs = [Request(rid=i, prompt=p.copy(), max_new=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    st = srv.run_until_drained(2000).asdict()
    st.pop("wall_s")
    return {"tokens": [list(map(int, r.out)) for r in reqs],
            "ttft": [(r.arrival_tick, r.first_token_tick) for r in reqs],
            "done": all(r.done and not r.aborted for r in reqs),
            "stats": st, "tick_log": [tuple(t) for t in srv.tick_log]}


def trainer(cfg, ckpt_dir: str, mesh=None):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                     global_batch=TRAIN["batch"], seed=3)
    tc = TrainerConfig(total_steps=TRAIN["steps"], ckpt_every=TRAIN["steps"],
                       ckpt_dir=ckpt_dir, base_lr=TRAIN["lr"], warmup=0,
                       log_every=100)
    return Trainer(cfg, tc, ds, mesh=mesh, device="cpu")


def _train_case(mesh, cfg, inp, out_dir):
    """``loss_and_grads`` through the model on the rank's rows, from the
    reference's train state loaded as shards (gradients gathered whole,
    and their global norm over the shards); then a Trainer's 2 steps on
    the mesh, saved at step 2: the state gathered whole, and whether
    restoring the checkpoint onto the mesh gives back this rank's shards
    bitwise."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data.pipeline import local_batch
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    model = train_state_from_jax(cfg, inp["jstate"], device="cpu",
                                 mesh=mesh)["params"]
    named = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in inp["train"].items()}
    with S.train_mesh_context(mesh):
        loss, metrics, grads = S.loss_and_grads(
            cfg, model, local_batch(batch, mesh, 1))
    _, norm = clip_by_global_norm(dict(grads), float("inf"), mesh=mesh,
                                  specs={k: p._pspec
                                         for k, p in named.items()})
    out = {"loss": loss.numpy(), "aux": metrics["aux_loss"].numpy(),
           "norm": norm.numpy(),
           "grads": {k: C.gather_whole(g, named[k]._pspec, mesh).numpy()
                     for k, g in grads.items()}}
    ck = f"{out_dir}/ckpt"
    tr = trainer(cfg, ck, mesh)
    tr.run()
    out["history"] = tr.history
    state = tr.state
    back, at = ckpt.restore_train_state(ck, cfg, mesh=mesh, device="cpu")
    pairs = [(a, b) for a, b in zip(state["params"].parameters(),
                                    back["params"].parameters())]
    pairs += [(state["opt"][m][k], back["opt"][m][k])
              for m in ("m", "v") for k in state["opt"][m]]
    out["restored_on_mesh"] = at == TRAIN["steps"] and all(
        torch.equal(a.detach(), b.detach()) for a, b in pairs)
    named = dict(state["params"].named_parameters())
    out["state"] = {
        "params": {k: C.gather_whole(p.detach(), p._pspec, mesh).numpy()
                   for k, p in named.items()},
        **{m: {k: C.gather_whole(t, named[k]._pspec, mesh).numpy()
               for k, t in state["opt"][m].items()} for m in ("m", "v")}}
    return out


def run(rank: int, out_dir: str):
    """One rank: every case on the inputs in ``inputs.pt``; its payload
    to ``rank<r>.pt``."""
    from _torch_mesh_world import _wait_for_inputs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    inp = _wait_for_inputs(f"{out_dir}/inputs.pt")
    sc, gc = _port_cfgs()
    out = {"coords": mesh.coords, "moe": {}}
    for cf in CAPACITY_FACTORS:
        out["moe"][cf] = _moe_case(mesh, moe_cfg(sc, gc, cf), inp["moe"])
    cfg = model_cfg(sc, gc)
    model = _model(no_drop(cfg), inp["tree"], mesh)
    C.reset_counts()
    out["serve"] = serve(no_drop(cfg), model, inp["prompts"], mesh)
    out["serve"]["counts"] = dict(C.COUNTS)
    with S.serve_mesh_context(mesh):
        out["step"] = _step_logits(cfg, model, torch.from_numpy(
            inp["step_toks"])).numpy()
    out["train"] = _train_case(mesh, cfg, inp, out_dir)
    swa = swa_cfg(sc, gc)
    with S.serve_mesh_context(mesh):
        lg, pos, shape = ring_logits(swa, _model(swa, inp["swa_tree"], mesh),
                                     torch.from_numpy(inp["ring_toks"]),
                                     RING["max_len"])
    out["ring"] = {"logits": lg.numpy(), "pos": pos, "shape": tuple(shape)}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
