"""One rank of the 8-rank gloo world of tests/test_torch_wide_mesh.py (a
(2, 4) ("data", "model") mesh on the CPU), and the cases the test and the
ranks share.  Its model axis of 4 is wider than the smoke xLSTM's heads,
set to 2 and to 1 (``xlstm_cfg``: the smoke's 4 heads equal |model|), and
its data axis of 2 is wider than a batch of 1 and does not divide one of
3.  Imports torch and the port only: the reference stays in the parent.

Each rank runs every case on the inputs the parent saved as
``inputs.pt`` and saves one payload, ``rank<r>.pt``: the mLSTM and sLSTM
cores with heads below |model| (prefill, from a state, decode; the
gradients), attention over a cache split by sequence over "data"
(context-parallel: dense, kv-split, a chunk, the ring, a prefill's
returned slice), the MoE at a batch below the data axes (TP-in-expert and
expert-parallel), the mesh ``DecodeServer`` at 1 and 3 slots on smoke
zamba2, mixtral and the xLSTM, and a ``Trainer`` on the xLSTM, whose last
checkpoint the parent restores on one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = (2, 4)
RANKS = MESH[0] * MESH[1]
XL, HYB, SWA = "xlstm-1.3b", "zamba2-2.7b", "mixtral-8x7b"
DENSE, OLMO = "internlm2-1.8b", "olmo-1b"
# the smoke xLSTM's heads below |model| = 4: 2 ranks a head, 4 ranks a head
XL_HEADS = (2, 1)
# the cores: (batch over the 2 data ranks, prefill length, then a second
# prefill from its state, then decode steps)
CORE = dict(batch=4, seq=64, seq2=32, steps=3)
# attention: 3 slots (whole on both data ranks) over caches split by
# sequence; (arch, kv heads or None for the smoke's, cache case)
ATTN_B = 3
ATTN = {"dense": (OLMO, None, "decode"),
        "dense_split": (DENSE, None, "decode"),
        "chunk": (OLMO, None, "chunk"),
        "chunk_split": (DENSE, None, "chunk"),
        "ring": (SWA, 4, "ring"),
        "ring_split": (SWA, None, "ring"),
        "prefill": (OLMO, None, "prefill"),
        "prefill_split": (DENSE, None, "prefill")}
MAX_LEN = 40
# decode: slot 2 past the cache end (its write clamps onto row 39)
DECODE = dict(pos=(5, 27, 44), steps=2)
# a chunk of 8: slot 0 across the data ranks' boundary (row 20), slot 1
# past the cache end, slot 2 with 5 real tokens
CHUNK = dict(seq=8, pos=(15, 36, 12), n_valid=(8, 8, 5))
# the ring of 32 (two data ranks of 16 rows): past its wrap, past its
# window not yet wrapped, and not yet full
RING = dict(pos=(40, 70, 5), steps=3)
PREFILL_SEQ = 32
# the MoE at a batch below the data axes: E 2 (TP-in-expert) and 4
# (expert-parallel over 4), batches of 1 and 3 of 8 tokens in groups of 8
MOE_EXPERTS = (2, 4)
MOE_BATCHES = (1, 3)
MOE_SEQ, MOE_CHUNK, MOE_CF = 8, 8, 0.8
# the mesh DecodeServer at 1 and 3 slots
SERVE_ARCHS = (HYB, SWA, XL)
SERVE_SLOTS = (1, 3)
SERVE = dict(max_len=64, admission="fifo", route_scope="tick",
             prefill_chunk=0)
SERVE_LENS = (3, 7, 5)
SERVE_NEW = 3
TRAIN = dict(batch=8, seq=16, lr=1e-3, steps=2)


def xlstm_cfg(smoke_config, get_config, heads: int = XL_HEADS[0]):
    """The smoke xLSTM with ``heads`` heads (below |model| = 4)."""
    return dataclasses.replace(smoke_config(get_config(XL)), n_heads=heads,
                               n_kv_heads=heads)


def attn_cfg(smoke_config, get_config, case: str):
    arch, kv, _ = ATTN[case]
    cfg = smoke_config(get_config(arch))
    return cfg if kv is None else dataclasses.replace(cfg, n_kv_heads=kv)


def moe_cfg(smoke_config, get_config, n_experts: int):
    cfg = smoke_config(get_config(SWA))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts, scan_chunk=MOE_CHUNK,
        capacity_factor=MOE_CF))


def serve_cfg(smoke_config, get_config, arch: str):
    """Smoke zamba2 with the ApproxFFN at the reference's capacities,
    smoke mixtral (4 experts) with MCMA dispatch on (its MoE takes the
    ApproxFFN's place), the xLSTM at 2 heads."""
    if arch == XL:
        return xlstm_cfg(smoke_config, get_config)
    cfg = smoke_config(get_config(arch))
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))


def serve_options(arch: str, slots: int) -> dict:
    """The server's options (MCMA dispatch where the arch has an
    ApproxFFN or an MoE in its place; the xLSTM has neither)."""
    return dict(SERVE, batch=slots, use_mcma_dispatch=arch != XL)


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
    if mesh is None:
        return mod.requires_grad_(True)
    specs, _ = param_pspecs(mesh, {f"{prefix}.{k}": v
                                   for k, v in mod.state_dict().items()})
    for k, prm in mod.named_parameters():
        prm.data = C.shard_tensor(mesh, prm.data, specs[f"{prefix}.{k}"])
        prm._pspec = specs[f"{prefix}.{k}"]
    return mod.requires_grad_(True)


def core_case(cfg, core: str, inp: dict, mesh=None) -> dict:
    """An mLSTM or sLSTM core (``core``) on ``inp``: a prefill with the
    gradients of sum(y * w) for x and every parameter (gathered whole),
    a second prefill from its state, then decode steps; each output and
    state whole over the rows.  On ``mesh`` the rank's rows, every state
    whole over "model" as the rules replicate it."""
    from repro_torch.models import xlstm
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import mesh_context
    from repro_torch.sharding.rules import P, dp_axes
    cls, fwd, prefix = {"mlstm": (xlstm.MLSTM, xlstm.mlstm_fwd,
                                  "mlstm.0.0.core"),
                        "slstm": (xlstm.SLSTM, xlstm.slstm_fwd,
                                  "slstm.0.core")}[core]
    p = _module(cls(cfg, "cpu"), prefix, inp["params"], mesh)
    rows = slice(None) if mesh is None else C.local_rows(
        mesh, dp_axes(mesh), CORE["batch"])
    loc = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows]))
    whole = (lambda t: t) if mesh is None else \
        (lambda t: C.gather_whole(t.contiguous(), P(dp_axes(mesh)), mesh))
    x = loc(inp["x"]).requires_grad_(True)
    out = {}
    with mesh_context(mesh):
        y, st = fwd(cfg, p, x, None)
        named = dict(p.named_parameters())
        gs = dict(zip(["x", *named], torch.autograd.grad(
            (y * loc(inp["w"])).sum(), [x, *named.values()])))
        if mesh is not None:
            dp = dp_axes(mesh)
            rep = [k for k, prm in named.items()
                   if not C._dp_dims(prm._pspec, dp)]
            gs.update(zip(rep, C.all_reduce_sum_many(
                [gs[k] for k in rep], dp, mesh)))
            gs = {"x": whole(gs["x"]),
                  **{k: C.gather_whole(gs[k], named[k]._pspec, mesh)
                     for k in named}}
        out["grads"] = {k: v.numpy() for k, v in gs.items()}
        runs = [("prefill", y, st)]
        with torch.no_grad():
            y2, st = fwd(cfg, p, loc(inp["x2"]), st)
            runs.append(("from_state", y2, st))
            for i, xs in enumerate(inp["steps"]):
                ys, st = fwd(cfg, p, loc(xs), st)
                runs.append((f"step{i}", ys, st))
    for name, yy, ss in runs:
        out[name] = {"y": whole(yy.detach()).numpy(),
                     "state": {k: whole(v.detach()).numpy()
                               for k, v in ss.items()},
                     "state_local": {k: v.detach().numpy()
                                     for k, v in ss.items()}}
    return out


def cache_shard(mesh, cache: dict) -> dict:
    """This rank's shard of one layer's cache ({name: ndarray}) as
    ``model.shard_cache`` places a model's (a batch below the data axes:
    the sequence over them)."""
    from repro_torch.models.model import shard_cache
    stacked = {k: torch.from_numpy(np.ascontiguousarray(
        v[None] if k in ("k", "v") else v)) for k, v in cache.items()}
    out = shard_cache(mesh, stacked)
    return {k: v[0] if k in ("k", "v") else v for k, v in out.items()}


def attn_case(mesh, cfg, case: str, inp: dict) -> dict:
    """One attention case on every row under ``whole_rows``: a prefill's
    output and the k/v slice it returns, or the steps over the rank's
    slice of the cache (outputs, the slice after the writes, the
    collectives)."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import mesh_context, whole_rows
    p = _module(L.Attention(cfg, "cpu"), "blocks.0.attn", inp["params"],
                mesh)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with mesh_context(mesh), whole_rows(), torch.no_grad():
        if ATTN[case][2] == "prefill":
            x = t(inp["x"])
            y, kv = L.attention_fwd(cfg, p, x, torch.arange(x.shape[1])[None])
            return {"out": y.numpy(),
                    "cache": {k: v.numpy() for k, v in kv.items()}}
        cache = cache_shard(mesh, inp["cache"])
        ys = []
        C.reset_counts()
        for xs, ps in inp["steps"]:
            if "n_valid" in inp:
                cache["n_valid"] = t(inp["n_valid"])
            o, cache = L.attention_fwd(cfg, p, t(xs), t(ps), cache)
            cache.pop("n_valid", None)
            ys.append(o.numpy())
        return {"out": np.stack(ys), "counts": dict(C.COUNTS),
                "cache": {k: v.numpy() for k, v in cache.items()}}


def moe_case(mesh, cfg, inp: dict) -> dict:
    """``moe_fwd`` on every row under ``whole_rows``: output, aux, each
    (token, choice)'s kept flag and the drop count."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import mesh_context, whole_rows
    p = _module(moe.MoE(cfg, "cpu"), "blocks.0.moe", inp["params"], mesh)
    x = torch.from_numpy(inp["x"])
    with mesh_context(mesh), whole_rows(), torch.no_grad():
        y, aux = moe.moe_fwd(cfg, p, x)
        router = C.gather_whole(p.router, p.router._pspec, mesh)
        xt = x.reshape(-1, x.shape[-1])
        r = moe.route_global(cfg, router, xt, mesh, ())
        kept = torch.zeros(xt.shape[0] * cfg.moe.top_k, dtype=torch.bool)
        kept[r.order.long()] = r.keep
        dropped, total = moe.dropped_choices(cfg, p, x)
    return {"y": y.numpy(), "aux": aux.numpy(),
            "gate_idx": r.gate_idx.numpy(),
            "kept": kept.reshape(-1, cfg.moe.top_k).numpy(),
            "dropped": (int(dropped), int(total))}


def model(cfg, tree, mesh=None):
    """A port ``Model`` holding the reference tree ``tree``: on ``mesh``
    this rank's shards."""
    from repro_torch.convert import params_from_jax
    from repro_torch.sharding import collectives as C
    m = params_from_jax(cfg, tree, device="cpu")
    if mesh is not None:
        C.shard_params(mesh, m)
    return m


def serve(cfg, params, prompts, slots: int, mesh=None):
    """The stream through a DecodeServer of ``slots`` slots (on ``mesh``
    when given): tokens, TTFT ticks, drain counters, the tick log and
    the cache's leaves at the end."""
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    srv = DecodeServer(cfg, params, options=ServeOptions(
        **serve_options(cfg.name, slots), mesh=mesh))
    reqs = [Request(rid=i, prompt=p.copy(), max_new=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    st = srv.run_until_drained(2000).asdict()
    st.pop("wall_s")
    cache = {}
    for k, v in srv.cache.items():
        for kk, vv in (v.items() if isinstance(v, dict) else ((None, v),)):
            cache[k if kk is None else f"{k}.{kk}"] = vv.numpy()
    return {"tokens": [list(map(int, r.out)) for r in reqs],
            "ttft": [(r.arrival_tick, r.first_token_tick) for r in reqs],
            "done": all(r.done and not r.aborted for r in reqs),
            "stats": st, "tick_log": [tuple(t) for t in srv.tick_log],
            "cache": cache}


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
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    inp = _wait_for_inputs(f"{out_dir}/inputs.pt")
    sc, gc = _port_cfgs()
    out = {"coords": mesh.coords, "core": {}, "attn": {}, "moe": {},
           "serve": {}}
    for h in XL_HEADS:
        for core in ("mlstm", "slstm"):
            out["core"][h, core] = core_case(xlstm_cfg(sc, gc, h), core,
                                             inp["core"][h, core], mesh)
    for case in ATTN:
        out["attn"][case] = attn_case(mesh, attn_cfg(sc, gc, case), case,
                                      inp["attn"][case])
    for e in MOE_EXPERTS:
        for b in MOE_BATCHES:
            out["moe"][e, b] = moe_case(mesh, moe_cfg(sc, gc, e),
                                        inp["moe"][e, b])
    for arch in SERVE_ARCHS:
        cfg = serve_cfg(sc, gc, arch)
        for slots in SERVE_SLOTS:
            out["serve"][arch, slots] = serve(
                cfg, model(cfg, inp["serve"][arch], mesh), inp["prompts"],
                slots, mesh)
    tr = trainer(xlstm_cfg(sc, gc), f"{out_dir}/ckpt", mesh)
    tr.run()
    out["train"] = {"history": tr.history,
                    "params": gathered_params(tr.state, mesh)}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
