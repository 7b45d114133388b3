"""One rank of the 8-rank gloo world of tests/test_torch_narrow_mesh.py (a
(2, 4) ("data", "model") mesh on the CPU, whose model axis of 4 is wider
than the smoke configs' kv heads and than an MoE's 2 or 6 experts), and
the cases the test and the ranks share.  Imports torch and the port only:
the reference stays in the parent.

Each rank runs every case on the inputs the parent saved as
``inputs.pt`` and saves one payload, ``rank<r>.pt``: attention with a
head_dim-split cache (prefill with its gradients, dense and paged decode,
chunked prefill, the ring buffer), TP-in-expert MoE (output, aux,
per-choice drops, gradients) at 2 and 6 experts, the mesh ``DecodeServer``
on smoke internlm2 (both switch backends, dense and paged, chunked) and
on smoke mixtral at 2 experts, and a ``Trainer`` on both, whose last
checkpoint the parent restores on one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = (2, 4)
RANKS = MESH[0] * MESH[1]
DENSE, SWA = "internlm2-1.8b", "mixtral-8x7b"
# attention: a prefill of (batch, seq) (mixtral's past its window of 32),
# then caches of max_len rows (pages of `page`, `n_pages` in the pool)
ATTN = {DENSE: dict(batch=4, seq=32), SWA: dict(batch=4, seq=64)}
CACHE = dict(max_len=40, page=8, n_pages=12)
# decode at these positions: one at the last row, one past the end (its
# write clamps onto row max_len - 1 as the reference's, caveat g)
DECODE_POS = (13, 17, 39, 44)
# -1 entries: unallocated pages (their writes go to the trash page).  A
# hole reads page 0 (masked where a real slot reads it), which no case
# writes: a data shard's pool holds its own slots' writes only
BLOCK_TABLE = ((0, 1, 2, 3, 4), (5, 6, -1, -1, -1), (7, 8, 9, 10, 11),
               (-1, -1, -1, -1, -1))
# a chunk of 8 at these offsets, with this many real tokens (slot 1 runs
# past the cache end, slot 2 sits the chunk out)
CHUNK = dict(seq=8, pos=(9, 36, 0, 12), n_valid=(8, 8, 0, 5))
# the ring: decode steps from these positions (two wrapped, two not yet)
RING = dict(pos=(40, 70, 5, 31), steps=3)
# TP-in-expert: E below and above |model|, neither dividing; (batch, seq,
# scan_chunk): one group spanning both data ranks, groups that a data
# rank's tokens cut (one spans the two), and whole groups per data rank;
# a capacity factor that drops choices
MOE_EXPERTS = (2, 6)
MOE_CASES = {"one-group": (4, 8, 0), "spanning": (6, 4, 8),
             "whole": (4, 8, 16)}
MOE_CF = 0.8
NO_CLIP = {"exact_frac": 1.0, "invoke_frac": 1.0}
SERVE = dict(batch=4, max_len=64, admission="fifo", use_mcma_dispatch=True,
             route_scope="tick")
# (backend, kv_page_size): the internlm2 runs, chunked by 4
SERVE_RUNS = (("pallas", 0), ("pallas", 4), ("pallas_fused", 0),
              ("pallas_fused", 4))
SERVE_LENS = (3, 9, 14, 5, 11, 6)
SERVE_NEW = 5
TRAIN = dict(batch=8, seq=16, lr=1e-3, steps=2)


def attn_cfg(smoke_config, get_config, arch: str):
    return smoke_config(get_config(arch))


def moe_cfg(smoke_config, get_config, n_experts: int, chunk: int):
    """Smoke mixtral's MoE with ``n_experts`` experts (d_ff 128 divides
    over 4), ``scan_chunk`` = ``chunk``, at ``MOE_CF``."""
    cfg = smoke_config(get_config(SWA))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts, scan_chunk=chunk,
        capacity_factor=MOE_CF))


def serve_cfg(smoke_config, get_config, arch: str):
    """The served configs: smoke internlm2 with the ApproxFFN at no-clip
    capacities, smoke mixtral at 2 experts with MCMA dispatch on (the
    MoE takes the ApproxFFN's place; the server's ``use_mcma_dispatch``
    needs it)."""
    cfg = smoke_config(get_config(arch))
    if arch == SWA:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=2))
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, **NO_CLIP))


def train_cfg(smoke_config, get_config, arch: str):
    cfg = smoke_config(get_config(arch))
    if arch == SWA:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=2))
    return cfg


def serve_options(arch: str, backend: str = "pallas", page: int = 0):
    return dict(SERVE, backend=backend, kv_page_size=page,
                prefill_chunk=0 if arch == SWA else 4)


def _port_cfgs():
    from repro_torch.configs.registry import get_config, smoke_config
    return smoke_config, get_config


def _module(mod, prefix: str, state: dict, mesh):
    """``mod`` holding ``state`` ({name: ndarray}), each parameter cut to
    this rank's block under the rules of a model's leaf ``prefix.name``
    (its spec kept as ``_pspec``), trainable."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import param_pspecs
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    specs, _ = param_pspecs(mesh, {f"{prefix}.{k}": v
                                   for k, v in mod.state_dict().items()})
    for k, prm in mod.named_parameters():
        prm.data = C.shard_tensor(mesh, prm.data, specs[f"{prefix}.{k}"])
        prm._pspec = specs[f"{prefix}.{k}"]
    return mod.requires_grad_(True)


def cache_shard(mesh, cache: dict) -> dict:
    """This rank's shard of one layer's cache ({name: ndarray}) as
    ``model.shard_cache`` (``rules.cache_pspecs``) places a model's: the
    k/v given the stacked layer dim for the rules, then without it."""
    from repro_torch.models.model import shard_cache
    stacked = {k: torch.from_numpy(np.ascontiguousarray(
        v[None] if k in ("k", "v") else v)) for k, v in cache.items()}
    out = shard_cache(mesh, stacked)
    return {k: v[0] if k in ("k", "v") else v for k, v in out.items()}


def _attn_case(mesh, cfg, inp):
    """Every attention path on the rank's rows: the prefill (output, the
    cache it returns, the gradients of sum(out * w) gathered whole), then
    decode, chunked prefill and (sliding window) ring decode over the
    rank's cache shard: outputs, the shard after the writes, and the
    collectives each ran."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import mesh_context
    from repro_torch.sharding.rules import P, dp_axes
    dp = dp_axes(mesh)
    p = _module(L.Attention(cfg, "cpu"), "blocks.0.attn", inp["params"],
                mesh)
    b = inp["x"].shape[0]
    rows = C.local_rows(mesh, dp, b)
    loc = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows]))
    x = loc(inp["x"]).requires_grad_(True)
    pos = torch.arange(x.shape[1])[None]
    out = {}
    with mesh_context(mesh):
        y, kv = L.attention_fwd(cfg, p, x, pos)
        named = dict(p.named_parameters())
        grads = torch.autograd.grad((y * loc(inp["w"])).sum(),
                                    [x, *named.values()])
        out["prefill"] = {
            "out": y.detach().numpy(),
            "cache": {k: t.detach().numpy() for k, t in kv.items()},
            "grads": {"x": C.gather_whole(grads[0], P(dp), mesh).numpy(),
                      "x_local": grads[0].numpy(),
                      **{k: C.gather_whole(g, named[k]._pspec, mesh)
                         .numpy() for k, g in zip(named, grads[1:])}}}
        with torch.no_grad():
            for name, c in inp["caches"].items():
                cache = cache_shard(mesh, c["cache"])
                cache["pos"] = cache["pos"][rows]      # the rank's slots
                ys = []
                C.reset_counts()
                for i, (xs, ps) in enumerate(c["steps"]):
                    if "n_valid" in c:
                        cache["n_valid"] = loc(c["n_valid"])
                    o, cache = L.attention_fwd(cfg, p, loc(xs), loc(ps),
                                               cache)
                    cache.pop("n_valid", None)
                    ys.append(o.numpy())
                out[name] = {"out": np.stack(ys), "counts": dict(C.COUNTS),
                             "cache": {k: v.numpy() for k, v in
                                       cache.items()}}
    return out


def _moe_case(mesh, cfg, inp):
    """``moe_fwd`` on the rank's rows (TP-in-expert): output and aux, each
    (token, choice)'s kept flag, the global drop count and the gradients
    of sum(out * w) + aux gathered whole."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import mesh_context
    from repro_torch.sharding.rules import P, dp_axes
    dp = dp_axes(mesh)
    p = _module(moe.MoE(cfg, "cpu"), "blocks.0.moe", inp["params"], mesh)
    rows = C.local_rows(mesh, dp, inp["x"].shape[0])
    x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
    w = torch.from_numpy(inp["w"][rows])
    C.reset_counts()
    with mesh_context(mesh):
        y, aux = moe.moe_fwd(cfg, p, x)
        counts = dict(C.COUNTS)
        named = dict(p.named_parameters())
        grads = torch.autograd.grad((y * w).sum() + aux,
                                    [x, *named.values()])
        router = C.gather_whole(p.router.detach(), p.router._pspec, mesh)
        with torch.no_grad():
            xt = x.detach().reshape(-1, x.shape[-1])
            r = moe.route_global(cfg, router, xt, mesh, dp)
            kept = torch.zeros(xt.shape[0] * cfg.moe.top_k, dtype=torch.bool)
            kept[r.order.long()] = r.keep
        dropped, total = moe.dropped_choices(cfg, p, x.detach())
    whole = lambda t: C.gather_whole(t.contiguous(), P(dp), mesh).numpy()
    return {"y": whole(y.detach()), "y_local": y.detach().numpy(),
            "aux": aux.detach().numpy(), "counts": counts,
            "gate_idx": whole(r.gate_idx),
            "kept": whole(kept.reshape(-1, cfg.moe.top_k)),
            "dropped": (int(dropped), int(total)),
            "grads": {"x": whole(grads[0]), "x_local": grads[0].numpy(),
                      **{k: C.gather_whole(g, named[k]._pspec, mesh).numpy()
                         for k, g in zip(named, grads[1:])}}}


def model(cfg, tree, mesh=None):
    """A port ``Model`` holding the reference tree ``tree``: on ``mesh``
    this rank's shards."""
    from repro_torch.convert import params_from_jax
    from repro_torch.sharding import collectives as C
    m = params_from_jax(cfg, tree, device="cpu")
    if mesh is not None:
        C.shard_params(mesh, m)
    return m


def serve(cfg, params, prompts, options: dict, mesh=None):
    """The stream through a DecodeServer (on ``mesh`` when given):
    tokens, TTFT ticks, drain counters and the tick log."""
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    srv = DecodeServer(cfg, params,
                       options=ServeOptions(**options, mesh=mesh))
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
    return Trainer(cfg, tc, ds, mesh=mesh, seed=0, device="cpu")


def gathered_params(state, mesh=None) -> dict:
    """{name: ndarray} of a train state's parameters, whole."""
    from repro_torch.sharding import collectives as C
    return {k: (p.detach() if mesh is None else
                C.gather_whole(p.detach(), p._pspec, mesh)).numpy()
            for k, p in state["params"].named_parameters()}


def run(rank: int, out_dir: str):
    """One rank: every case on the inputs in ``inputs.pt``; its payload
    to ``rank<r>.pt``."""
    from _torch_mesh_world import _wait_for_inputs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import collectives as C
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    inp = _wait_for_inputs(f"{out_dir}/inputs.pt")
    sc, gc = _port_cfgs()
    out = {"coords": mesh.coords, "attn": {}, "moe": {}, "serve": {},
           "train": {}}
    for arch in ATTN:
        out["attn"][arch] = _attn_case(mesh, attn_cfg(sc, gc, arch),
                                       inp["attn"][arch])
    for e in MOE_EXPERTS:
        for case, (_, _, ck) in MOE_CASES.items():
            out["moe"][e, case] = _moe_case(mesh, moe_cfg(sc, gc, e, ck),
                                            inp["moe"][e, case])
    for arch in (DENSE, SWA):
        cfg = serve_cfg(sc, gc, arch)
        runs = SERVE_RUNS if arch == DENSE else (("pallas", 0),)
        for backend, page in runs:
            C.reset_counts()
            res = serve(cfg, model(cfg, inp["serve"][arch], mesh),
                        inp["prompts"], serve_options(arch, backend, page),
                        mesh)
            res["counts"] = dict(C.COUNTS)
            out["serve"][arch, backend, page] = res
    for arch in (DENSE, SWA):
        cfg = train_cfg(sc, gc, arch)
        tr = trainer(cfg, f"{out_dir}/ckpt_{arch}", mesh)
        tr.run()
        out["train"][arch] = {"history": tr.history,
                              "params": gathered_params(tr.state, mesh)}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
