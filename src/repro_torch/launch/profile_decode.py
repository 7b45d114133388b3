"""Where a decode tick's time goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--backend pallas] [--ticks 6] [--seed 0]

Serves the full-width internlm2-1.8b (all 24 layers, random weights from
``--seed``, MCMA dispatch, batch 8) until every slot is decoding, then:
  * times ``--ticks`` decode steps with the host clock (each ended by a
    synchronize), and counts the host-device synchronizations one step
    makes (``torch.cuda.set_sync_debug_mode``);
  * traces the same steps with ``torch.profiler`` and prints the device
    busy time per tick (the sum over GPU kernels only: an operator's
    device time is its kernels' time, so adding both would count it
    twice), the kernel launches per tick, the idle share, the top kernels
    by device time and the top operators by calls.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import warnings

TOP = 15


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "pallas_fused", "xla"))
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.runtime import steps

    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    params = M.init_model(args.seed, cfg, device=dev)
    step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                  with_stats=True, backend=args.backend)
    b = 8
    cache = M.init_cache(cfg, b, 256, device=dev)
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))
                            .astype(np.int32)).to(dev)
    mask = torch.ones(b, dtype=torch.bool, device=dev)

    def tick():
        nonlocal toks, cache
        logits, cache, m = step(params, cache, toks, mask)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        return float(m["invocation"])

    for _ in range(3):
        tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        tick()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.ticks

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tick()
    torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.ticks
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.ticks
    launches = sum(e.count for e in kernels) / args.ticks
    print(f"{cfg.name} {cfg.n_layers} layers, batch {b}, backend "
          f"{args.backend}: {host_ms:.2f} ms/tick (host clock), "
          f"{wall_ms:.2f} ms/tick under the profiler, device busy "
          f"{busy:.2f} ms/tick in {launches:.0f} kernel launches, idle "
          f"share {max(0.0, 1 - busy / host_ms):.3f} of the host-clock tick "
          f"({max(0.0, 1 - busy / wall_ms):.3f} under the profiler)")
    print(f"host-device synchronizations in one tick: {len(syncs)}")
    for s in sorted(set(syncs)):
        print(f"  {syncs.count(s)} x {s}")
    print(f"top {TOP} kernels by device time per tick:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3 / args.ticks:9.3f} ms "
              f"{e.count // args.ticks:6d} launches  {e.key[:90]}")
    print(f"top {TOP} operators by calls per tick:")
    for e in sorted(ops, key=lambda e: -e.count)[:TOP]:
        print(f"  {e.count // args.ticks:6d} calls  "
              f"{e.self_device_time_total / 1e3 / args.ticks:9.3f} ms  "
              f"{e.key}")


if __name__ == "__main__":
    main()
