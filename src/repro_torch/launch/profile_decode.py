"""Where a decode tick's time goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--arch internlm2-1.8b | stablelm-1.6b | moonshot-v1-16b-a3b |
        xlstm-1.3b | zamba2-2.7b] [--backend pallas] \\
        [--route-scope layer | tick] [--prefill-chunk 64] \\
        [--qos] [--library-size 6 --n-resident 3] [--autotune] \\
        [--ticks 6] [--seed 0]

Builds the full-width model (all layers, random weights from ``--seed``,
batch 8, max_len 256).  The dense archs (internlm2-1.8b, stablelm-1.6b)
and moonshot-v1-16b-a3b (whose MoE takes the ApproxFFN's place: no
switch kernel, no invocation rate; 56 GB of bf16 weights) run through a
``DecodeServer`` with MCMA dispatch on ``--backend`` at
``--route-scope``, 8 requests admitted into its slots, and each tick is
the server's own: its step at the autotuner's rung, its tensor inputs,
its one device read and its controllers (``profile_server``).
xlstm-1.3b runs its bare decode step; zamba2-2.7b its bare decode step
with MCMA dispatch on ``--backend`` at ``--route-scope`` (the shared
block's ApproxFFN).
Then:
  * times ``--ticks`` decode ticks with the host clock (each ended by a
    synchronize), and counts the host-device synchronizations one tick
    makes (``torch.cuda.set_sync_debug_mode``);
  * traces the same ticks with ``torch.profiler`` and prints the device
    busy time per tick (the sum over GPU kernels only: an operator's
    device time is its kernels' time, so adding both would count it
    twice), the kernel launches per tick, the idle share, the top kernels
    by device time and the top operators by calls.
With ``--prefill-chunk`` S > 0 (the dense archs) it then does the same
for ``--ticks`` prefill-chunk ticks of S tokens in each of the 8 slots
(the server's chunk step from position 0, the invocation rate read as the
server reads it).  For xlstm-1.3b and zamba2-2.7b it does the same for
``--ticks`` prefills of an (8, 256) prompt batch.

The serve-time features are the server's options: ``--qos`` serves the
default tier table with the 8 slots' tiers round-robin over it;
``--library-size N --n-resident R`` a model of N approximators with R
resident; ``--autotune`` the default ladder with a 0.05 drop budget.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import warnings

TOP = 15


def profiled(torch, fn, n):
    """Host ms per call of ``fn`` (untraced, then traced) and the traced
    GPU kernels and aten operators, each summed over ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    return host_ms, wall_ms, kernels, ops


def report(what, host_ms, wall_ms, kernels, ops, n):
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    print(f"{what}: {host_ms:.2f} ms (host clock), {wall_ms:.2f} ms under "
          f"the profiler, device busy {busy:.2f} ms in {launches:.0f} "
          f"kernel launches, idle share {max(0.0, 1 - busy / host_ms):.3f} "
          f"of the host-clock time ({max(0.0, 1 - busy / wall_ms):.3f} under "
          "the profiler)")
    print(f"top {TOP} kernels by device time per call:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"{e.count // n:6d} launches  {e.key[:90]}")
    print(f"top {TOP} operators by calls per call:")
    for e in sorted(ops, key=lambda e: -e.count)[:TOP]:
        print(f"  {e.count // n:6d} calls  "
              f"{e.self_device_time_total / 1e3 / n:9.3f} ms  {e.key}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=("internlm2-1.8b", "stablelm-1.6b",
                             "moonshot-v1-16b-a3b", "xlstm-1.3b",
                             "zamba2-2.7b"))
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "pallas_fused", "xla"))
    ap.add_argument("--route-scope", default="layer",
                    choices=("layer", "tick"))
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="also profile prefill-chunk ticks of this many "
                         "tokens per slot (the dense archs)")
    ap.add_argument("--qos", action="store_true",
                    help="a mixed-tier batch on the default tier table")
    ap.add_argument("--library-size", type=int, default=0,
                    help="serve a library of this many approximators")
    ap.add_argument("--n-resident", type=int, default=0,
                    help="resident slots with --library-size (0 = "
                         "min(4, library_size))")
    ap.add_argument("--autotune", action="store_true",
                    help="walk the default capacity ladder per tick")
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.runtime import steps

    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    b = 8
    rng = np.random.default_rng(args.seed)
    if cfg.family in ("dense", "moe"):
        profile_server(args, np, torch, cfg, dev, b, rng)
        return
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
        step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                      backend=args.backend,
                                      route_scope=args.route_scope)
    else:
        step = steps.make_decode_step(cfg)
    params = M.init_model(args.seed, cfg, device=dev)
    cache = M.init_cache(cfg, b, 256, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))
                            .astype(np.int32)).to(dev)
    mask = torch.ones(b, dtype=torch.bool, device=dev)

    def tick():
        nonlocal toks, cache
        logits, cache = step(params, cache, toks, mask)
        toks = logits.argmax(-1).to(torch.int32)[:, None]

    for _ in range(3):
        tick()
    label = "" if cfg.family != "hybrid" else (
        f", backend {args.backend}, route_scope {args.route_scope}")
    measure(torch, f"{cfg.name} {cfg.n_layers} layers, decode tick, batch "
            f"{b}{label}", tick, args.ticks)
    del cache
    prefill = steps.make_prefill_step(
        steps.mcma_serve_config(cfg, backend=args.backend)
        if cfg.approx.enable else cfg)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 256))
                              .astype(np.int32)).to(dev)
    prefill(params, {"inputs": prompt})
    report(f"{cfg.name} prefill of {b} x 256 tokens",
           *profiled(torch, lambda: prefill(params, {"inputs": prompt}),
                     args.ticks), args.ticks)


def dense_server(args, np, cfg, dev, b, rng):
    """A ``DecodeServer`` over the full-width dense model with the
    features the flags ask for, and ``b`` one-token requests admitted
    into its slots (tiers round-robin over the table under ``--qos``).
    Returns the server and the profile rows' label."""
    from repro_torch.models import model as M
    from repro_torch.runtime.options import LibrarySpec, ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    opts = dict(batch=b, max_len=256, use_mcma_dispatch=True,
                backend=args.backend, route_scope=args.route_scope,
                prefill_chunk=args.prefill_chunk)
    label = f", backend {args.backend}, route_scope {args.route_scope}"
    if args.library_size:
        r = args.n_resident or min(4, args.library_size)
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, library_size=args.library_size))
        opts["library"] = LibrarySpec(args.library_size, r)
        label += f", library {args.library_size} ({r} resident)"
    if args.qos:
        opts["qos_tiers"] = True
    if args.autotune:
        opts.update(autotune=True, drop_budget=0.05)
        label += ", autotune (default ladder)"
    params = M.init_model(args.seed, cfg, device=dev)
    srv = DecodeServer(cfg, params, options=ServeOptions(**opts))
    n_tiers = len(srv.tier_bounds) if srv.tier_bounds else 0
    if n_tiers:
        label += f", QoS tiers {srv.tier_bounds} mixed"
    for i in range(b):
        srv.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 1).astype(np.int32),
            max_new=128, tier=i % n_tiers if n_tiers else None))
    srv._admit()
    return srv, label


def profile_server(args, np, torch, cfg, dev, b, rng):
    """The dense (and MoE) family's ticks as ``DecodeServer`` runs them:
    its step at the controller's rung (``_active_step``), its tensor inputs
    (``_step_inputs``: the slots' tier vector, the margins, the resident
    set), its one device read (``_read_tick``) and its controllers
    (``_observe_decode``), on 8 decoding slots; then its chunk step."""
    srv, label = dense_server(args, np, cfg, dev, b, rng)
    cfg = srv.cfg
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))
                            .astype(np.int32)).to(dev)
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    rungs = []

    def tick():
        nonlocal toks
        if srv.controller is not None:
            rungs.append(srv.controller.index)
        logits, srv.cache, m = srv._active_step()(
            srv.params, srv.cache, toks, mask, **srv._step_inputs())
        nxt = torch.argmax(logits, -1)
        host = srv._read_tick(m, nxt, srv.cache["pos"])
        if "dropped_rows" in host:          # no dispatch stats on an MoE
            srv._observe_decode(host)
        toks = nxt.to(torch.int32)[:, None]

    for _ in range(3):
        tick()
    measure(torch, f"{cfg.name} {cfg.n_layers} layers, decode tick, batch "
            f"{b}{label}", tick, args.ticks)
    if args.prefill_chunk:
        s = args.prefill_chunk
        ctoks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                 .astype(np.int32)).to(dev)
        nv = torch.full((b,), s, dtype=torch.int32, device=dev)

        def chunk_tick():
            srv.cache["pos"].zero_()
            srv.cache, m = srv._active_chunk_step()(
                srv.params, srv.cache, ctoks, nv, **srv._step_inputs())
            if "invocation" in m:           # the server reads it per tick
                float(m["invocation"])

        for _ in range(3):
            chunk_tick()
        measure(torch, f"{cfg.name} {cfg.n_layers} layers, prefill-chunk "
                f"tick of {b} x {s} tokens{label}", chunk_tick, args.ticks)
    if srv.controller is not None:
        print(f"autotune: decode ticks ran on rungs {rungs}, "
              f"{len(srv._steps)} decode and {len(srv._chunk_steps)} chunk "
              f"step objects; switches "
              f"{srv.controller.summary()['switches']}")
    if srv.residency_controller is not None:
        summ = srv.residency_controller.summary()
        print(f"residency: final {summ['final_residency']}, "
              f"{summ['swap_count']} swaps")


def measure(torch, what, fn, n):
    """Host syncs of one call of ``fn``, then its profile over ``n``."""
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    report(what, *profiled(torch, fn, n), n)
    print(f"host-device synchronizations in one call: {len(syncs)}")
    for s in sorted(set(syncs)):
        print(f"  {syncs.count(s)} x {s}")


if __name__ == "__main__":
    main()
