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
