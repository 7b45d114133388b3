"""Where a decode tick's time goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--arch internlm2-1.8b | xlstm-1.3b] [--backend pallas] \\
        [--route-scope layer | tick] [--prefill-chunk 64] \\
        [--ticks 6] [--seed 0]

Serves the full-width model (all layers, random weights from ``--seed``,
batch 8, max_len 256; internlm2-1.8b with MCMA dispatch on ``--backend``
at ``--route-scope``) until every slot is decoding, then:
  * times ``--ticks`` decode steps with the host clock (each ended by a
    synchronize), and counts the host-device synchronizations one step
    makes (``torch.cuda.set_sync_debug_mode``);
  * traces the same steps with ``torch.profiler`` and prints the device
    busy time per tick (the sum over GPU kernels only: an operator's
    device time is its kernels' time, so adding both would count it
    twice), the kernel launches per tick, the idle share, the top kernels
    by device time and the top operators by calls.
With ``--prefill-chunk`` S > 0 (internlm2-1.8b) it then does the same for
``--ticks`` prefill-chunk ticks of S tokens in each of the 8 slots
(``steps.make_prefill_chunk_step`` from position 0, the invocation rate
read as the server reads it).  For xlstm-1.3b it does the same for
``--ticks`` prefills of an (8, 256) prompt batch.  Needs a CUDA device.
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
                    choices=("internlm2-1.8b", "xlstm-1.3b"))
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "pallas_fused", "xla"))
    ap.add_argument("--route-scope", default="layer",
                    choices=("layer", "tick"))
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="also profile prefill-chunk ticks of this many "
                         "tokens per slot (internlm2-1.8b)")
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
    dense = cfg.family == "dense"
    if dense:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    params = M.init_model(args.seed, cfg, device=dev)
    kw = dict(use_mcma_dispatch=dense, with_stats=dense,
              backend=args.backend,
              route_scope=args.route_scope if dense else None)
    step = steps.make_decode_step(cfg, **kw)
    b = 8
    cache = M.init_cache(cfg, b, 256, device=dev)
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))
                            .astype(np.int32)).to(dev)
    mask = torch.ones(b, dtype=torch.bool, device=dev)

    def tick():
        nonlocal toks, cache
        logits, cache, *m = step(params, cache, toks, mask)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        if m:
            float(m[0]["invocation"])        # the server reads it per tick

    for _ in range(3):
        tick()
    scope = f", backend {args.backend}, route_scope {args.route_scope}" \
        if dense else ""
    measure(torch, f"{cfg.name} {cfg.n_layers} layers, decode tick, batch "
            f"{b}{scope}", tick, args.ticks)
    if dense and args.prefill_chunk:
        del cache
        s = args.prefill_chunk
        chunk = steps.make_prefill_chunk_step(cfg, **kw)
        ccache = M.init_cache(cfg, b, 256, device=dev)
        ctoks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                 .astype(np.int32)).to(dev)
        nv = torch.full((b,), s, dtype=torch.int32, device=dev)

        def chunk_tick():
            ccache["pos"].zero_()
            _, m = chunk(params, ccache, ctoks, nv)
            float(m["invocation"])           # the server reads it per tick

        for _ in range(3):
            chunk_tick()
        measure(torch, f"{cfg.name} {cfg.n_layers} layers, prefill-chunk "
                f"tick of {b} x {s} tokens{scope}", chunk_tick, args.ticks)
    if dense:
        return
    del cache
    prefill = steps.make_prefill_step(cfg)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 256))
                              .astype(np.int32)).to(dev)
    prefill(params, {"inputs": prompt})
    report(f"{cfg.name} prefill of {b} x 256 tokens",
           *profiled(torch, lambda: prefill(params, {"inputs": prompt}),
                     args.ticks), args.ticks)


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
