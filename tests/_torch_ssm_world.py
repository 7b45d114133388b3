"""One rank of the 8-rank gloo world of tests/test_torch_ssm_mesh.py (a
(4, 2) ("data", "model") mesh on the CPU: 4 data shards, each model rank
holding half the heads of every Mamba2, mLSTM and sLSTM block), and the
configs and cases the test and the ranks share.  Imports torch and the
port only: the reference stays in the parent.

Each rank runs every case on the inputs the parent saved as
``inputs.pt`` and saves one payload, ``rank<r>.pt``: the cores
(``mamba_fwd``, ``mlstm_fwd``, ``slstm_fwd``) on the rank's rows and
heads with their gradients, each family's decode token by token, a slot
reset on the data shard that holds it, the mesh ``DecodeServer`` (the
hybrid on both weight-switch backends), and ``loss_and_grads``, the
training forward and a ``Trainer`` checkpoint saved on the mesh and
restored onto it.  ``core_case``, ``decode_case``, ``serve`` and
``train_case`` run on one device too (``mesh=None``): the parent's
single-device runs are the same code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = (4, 2)
RANKS = MESH[0] * MESH[1]
HYBRID, XLSTM = "zamba2-2.7b", "xlstm-1.3b"
ARCHS = (HYBRID, XLSTM)
# the cores: (core, S, from a carried state, with gradients)
CORES = {"mamba_chunked": ("mamba", 64, False, True),
         "mamba_chunked_state": ("mamba", 64, True, False),
         "mamba_step": ("mamba", 1, True, False),
         "mlstm_chunked": ("mlstm", 64, False, True),
         "mlstm_chunked_state": ("mlstm", 32, True, False),
         "mlstm_step": ("mlstm", 1, True, False),
         "slstm_scan": ("slstm", 32, False, True),
         "slstm_step": ("slstm", 1, True, False)}
CORE_BATCH = 8
# where a core's leaves sit in a model (their sharding rules' names)
PREFIX = {"mamba": "mamba.0.0.core.", "mlstm": "mlstm.0.0.core.",
          "slstm": "slstm.0.core."}
# decode token by token from an empty cache (the hybrid through the
# dispatch at tick scope); then a slot reset
DECODE = dict(batch=8, steps=9, max_len=32, reset_slot=5)
SERVE = dict(batch=4, max_len=64, admission="fifo", use_mcma_dispatch=True,
             route_scope="tick", prefill_chunk=8)
SERVE_LENS = (3, 9, 5, 7, 2, 6)
SERVE_NEW = 5
BACKENDS = ("pallas", "pallas_fused")
TRAIN = dict(batch=8, seq=16, lr=1e-3, steps=2)
# no capacity clips: every row gets the class it routes to, on one device
# and per data shard alike; an error bound at which exact and
# approximator labels both occur at a random init
APPROX = dict(enable=True, exact_frac=1.0, invoke_frac=1.0,
              route_scope="tick", error_bound=1.4)


def model_cfg(smoke_config, get_config, arch: str):
    """``arch``'s smoke config (float32) with the ApproxFFN on at no
    capacity clips (the hybrid's shared block; the xLSTM has none, but
    the server's ``use_mcma_dispatch`` needs it)."""
    cfg = smoke_config(get_config(arch))
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, **APPROX))


def _port_cfg(arch: str):
    from repro_torch.configs.registry import get_config, smoke_config
    return model_cfg(smoke_config, get_config, arch)


def core_module(core: str, cfg, tree: dict, mesh=None):
    """A port core holding the reference leaves ``tree``; on ``mesh`` each
    parameter cut to this rank's block under the rules of a model's
    leaf."""
    from repro_torch.models import mamba2, xlstm
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import param_pspecs
    cls = {"mamba": mamba2.Mamba, "mlstm": xlstm.MLSTM,
           "slstm": xlstm.SLSTM}[core]
    p = cls(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in tree.items()})
    if mesh is not None:
        specs, _ = param_pspecs(mesh, {PREFIX[core] + k: v
                                       for k, v in p.state_dict().items()})
        for k, prm in p.named_parameters():
            prm.data = C.shard_tensor(mesh, prm.data, specs[PREFIX[core] + k])
            prm._pspec = specs[PREFIX[core] + k]
    return p.requires_grad_(True)


def _fwd(core: str):
    from repro_torch.models import mamba2, xlstm
    return {"mamba": mamba2.mamba_fwd, "mlstm": xlstm.mlstm_fwd,
            "slstm": xlstm.slstm_fwd}[core]


def core_case(name: str, cfg, inp: dict, mesh=None) -> dict:
    """One core on its inputs (on ``mesh`` the rank's rows and heads):
    its output and final state whole, and with gradients those of
    sum(y * ry) / y.numel() + sum over the state leaves of sum(s * rs) /
    s.numel() (the global sizes: the mean over the global batch) for x
    and every parameter, gathered whole."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import mesh_context
    from repro_torch.sharding.rules import P, dp_axes
    core, s, with_state, grads = CORES[name]
    p = core_module(core, cfg, inp["params"][core], mesh)
    rows = slice(None) if mesh is None else C.local_rows(
        mesh, dp_axes(mesh), CORE_BATCH)
    heads = lambda t: t if mesh is None else t.narrow(
        1, C.model_index(mesh) * (t.shape[1] // mesh.size("model")),
        t.shape[1] // mesh.size("model"))
    x = torch.from_numpy(inp[name]["x"][rows]).requires_grad_(grads)
    state = None
    if with_state:
        state = {k: heads(torch.from_numpy(np.array(v[rows])))
                 for k, v in inp[name]["state"].items()}
    with mesh_context(mesh), torch.set_grad_enabled(grads):
        y, st = _fwd(core)(cfg, p, x, state)
        # every state leaf whole over "model" (a replicated consumer)
        st = {k: C.all_gather(v, "model", 1) if mesh is not None else v
              for k, v in st.items()}
        out = {}
        if grads:
            r = inp[name]["r"]
            loss = (y * torch.from_numpy(r["y"][rows])).sum() / r["y"].size
            for k in ("h", "c", "n"):
                if k in st:
                    loss = loss + (st[k] * torch.from_numpy(r[k][rows])) \
                        .sum() / r[k].size
            named = dict(p.named_parameters())
            gs = torch.autograd.grad(loss, [x, *named.values()])
            gs = dict(zip(["x", *named], gs))
            if mesh is not None:
                dp = dp_axes(mesh)
                rep = [k for k, prm in named.items()
                       if not C._dp_dims(prm._pspec, dp)]
                gs.update(zip(rep, C.all_reduce_sum_many(
                    [gs[k] for k in rep], dp, mesh)))
                gs = {"x_local": gs["x"],
                      "x": C.gather_whole(gs["x"], P(dp), mesh),
                      **{k: C.gather_whole(gs[k], named[k]._pspec, mesh)
                         for k in named}}
            out["grads"] = {k: v.numpy() for k, v in gs.items()}
    whole = (lambda t: t) if mesh is None else \
        (lambda t: C.gather_whole(t.contiguous(), P(dp_axes(mesh)), mesh))
    out["y_local"] = y.detach().numpy()
    out["y"] = whole(y.detach()).numpy()
    out["state"] = {k: whole(v.detach()).numpy() for k, v in st.items()}
    return out


def load_model(cfg, tree, mesh=None):
    """A port ``Model`` holding the reference tree ``tree``: on ``mesh``
    this rank's shards."""
    from repro_torch.convert import params_from_jax
    from repro_torch.sharding import collectives as C
    model = params_from_jax(cfg, tree, device="cpu")
    if mesh is not None:
        C.shard_params(mesh, model)
    return model


def decode_case(cfg, params, toks: np.ndarray, mesh=None) -> dict:
    """``toks`` (B, n) decoded one by one from an empty cache through the
    decode step (the hybrid's ApproxFFN through the dispatch at tick
    scope): each step's logits (B, n, V) and ``pos``; then slot
    ``reset_slot`` reset, and this rank's cache leaves before and after
    the reset."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    b, n = toks.shape
    step = S.make_decode_step(cfg, use_mcma_dispatch=True,
                              route_scope="tick")
    out = []
    with S.serve_mesh_context(mesh), torch.no_grad():
        cache = M.init_cache(cfg, b, DECODE["max_len"], device="cpu")
        for j in range(n):
            lg, cache = step(params, cache, torch.from_numpy(toks[:, j:j + 1]))
            out.append(lg)
        pos, before = cache["pos"].tolist(), _ssm_leaves(cache)
        fresh = M.init_cache(cfg, b, DECODE["max_len"], device="cpu")
        M.reset_slot(cfg, cache, fresh, DECODE["reset_slot"])
        after = _ssm_leaves(cache)
    return {"logits": torch.stack(out, 1).numpy(),
            "pos": pos, "before": before, "after": after}


def _ssm_leaves(cache) -> dict:
    """The recurrent state leaves of a cache, copied: {"mamba.h": ...}."""
    return {f"{head}.{k}": v.clone().numpy()
            for head in ("mamba", "mlstm", "slstm") if head in cache
            for k, v in cache[head].items()}


def serve(cfg, params, prompts, mesh=None, backend="pallas") -> dict:
    """The stream through a DecodeServer (on ``mesh`` when given):
    tokens, TTFT ticks, drain counters and the tick log."""
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    srv = DecodeServer(cfg, params, options=ServeOptions(
        **SERVE, backend=backend, mesh=mesh))
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


def train_case(cfg, jstate, batch, mesh=None) -> dict:
    """The training forward's logits and ``loss_and_grads`` through the
    model from the reference's train state (on ``mesh`` loaded as
    shards, on the rank's rows; gradients and logits gathered whole)."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data.pipeline import local_batch
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import P, dp_axes
    model = train_state_from_jax(cfg, jstate, device="cpu",
                                 mesh=mesh)["params"]
    named = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        batch = local_batch(batch, mesh, 1)
    with S.train_mesh_context(mesh):
        loss, metrics, grads = S.loss_and_grads(cfg, model, batch)
        with torch.no_grad():
            logits = M.forward(cfg, model, batch["inputs"])[0]
    if mesh is not None:
        logits = C.gather_whole(logits, P(dp_axes(mesh)), mesh)
        grads = {k: C.gather_whole(g, named[k]._pspec, mesh)
                 for k, g in grads.items()}
    return {"loss": loss.numpy(), "aux": metrics["aux_loss"].numpy(),
            "logits": logits.numpy(),
            "grads": {k: g.numpy() for k, g in grads.items()}}


def _trainer_case(cfg, mesh, ckpt: str) -> dict:
    """A Trainer's steps on the mesh, saved at its last step: its history,
    the state gathered whole, and whether restoring the checkpoint onto
    the mesh gives back this rank's shards bitwise."""
    from repro_torch.checkpoint import ckpt as ck
    from repro_torch.sharding import collectives as C
    tr = trainer(cfg, ckpt, mesh)
    tr.run()
    state = tr.state
    back, at = ck.restore_train_state(ckpt, cfg, mesh=mesh, device="cpu")
    pairs = [(a, b) for a, b in zip(state["params"].parameters(),
                                    back["params"].parameters())]
    pairs += [(state["opt"][m][k], back["opt"][m][k])
              for m in ("m", "v") for k in state["opt"][m]]
    named = dict(state["params"].named_parameters())
    return {"history": tr.history,
            "restored_on_mesh": at == TRAIN["steps"] and all(
                torch.equal(a.detach(), b.detach()) for a, b in pairs),
            "params": {k: C.gather_whole(p.detach(), p._pspec, mesh).numpy()
                       for k, p in named.items()},
            **{m: {k: C.gather_whole(t, named[k]._pspec, mesh).numpy()
                   for k, t in state["opt"][m].items()} for m in ("m", "v")}}


def run(rank: int, out_dir: str):
    """One rank: every case on the inputs in ``inputs.pt``; its payload
    to ``rank<r>.pt``."""
    from _torch_mesh_world import _wait_for_inputs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import collectives as C
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    inp = _wait_for_inputs(f"{out_dir}/inputs.pt")
    out = {"coords": mesh.coords, "core": {}, "counts": {}}
    for name, (core, *_) in CORES.items():
        cfg = _port_cfg(HYBRID if core == "mamba" else XLSTM)
        C.reset_counts()
        out["core"][name] = core_case(name, cfg, inp["core"], mesh)
        out["counts"][name] = dict(C.COUNTS)
    for arch in ARCHS:
        cfg = _port_cfg(arch)
        a = inp[arch]
        params = load_model(cfg, a["tree"], mesh)
        res = out[arch] = {"decode": decode_case(cfg, params, a["toks"],
                                                 mesh)}
        for be in BACKENDS if arch == HYBRID else BACKENDS[:1]:
            C.reset_counts()
            res[be] = serve(cfg, params, a["prompts"], mesh, be)
            res[be]["counts"] = dict(C.COUNTS)
        res["train"] = train_case(cfg, a["jstate"], a["train"], mesh)
        res["trainer"] = _trainer_case(cfg, mesh, f"{out_dir}/ckpt_{arch}")
    torch.save(out, f"{out_dir}/rank{rank}.pt")
