"""Serving launcher: batched decode with the continuous-batching server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --approx --mcma-dispatch [--backend pallas_fused] \\
        [--route-scope tick] [--prefill-chunk 64] \\
        [--kv-page-size 16 [--kv-pages 128]] [--qos [--qos-app bessel |
        --tier-bounds 0.05,0.1,0.2]] [--library-size 6 --n-resident 3]
        [--autotune [--drop-budget 0.05]] [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
        [--smoke] [--device cpu]

``--arch`` takes every architecture that reads tokens: the dense ones
(internlm2-1.8b, olmo-1b, stablelm-1.6b, stablelm-3b), xlstm-1.3b, the
zamba2-2.7b hybrid (MCMA on its shared block) and the MoE family
(moonshot-v1-16b-a3b; mixtral-8x7b, whose sliding window's ring buffer
takes no ``--kv-page-size``), where the MoE takes the FFN's place and
``--mcma-dispatch`` reports no invocation rate; musicgen-large and
internvl2-76b take embeddings, which the server does not feed.

Runs on the GPU unless ``--device cpu`` is given; the weights are random,
from ``--seed``.  Prompts load ``--prefill-chunk`` tokens per prefill
tick (default 16, as the reference's CLI; 0 = token by token; the xLSTM
and hybrid families and mixtral-8x7b always feed token by token).  With
``--qos`` the requests cycle through the tier table's bounds and the default tier, and
the per-tier ledger is printed; ``--library-size`` builds a library model and prints
the swaps; ``--autotune`` prints the rung trajectory and the ladder the
served counts suggest.

Mesh deployments (``--data``/``--model``, every family): one process per
rank serves the same requests SPMD (``DecodeServer(mesh=...)``:
parameters drawn as the rank's shards and the cache sharded by the
rules, each data shard dispatching its own rows, tensor parallelism over
"model", an MoE's experts over "model" with ``--model`` dividing them,
e.g. ``--arch moonshot-v1-16b-a3b --data 1 --model 4``, else each
expert's d_ff; fewer kv heads than ``--model`` over a head_dim-split
cache, e.g. ``--arch internlm2-1.8b --model 16``; the hybrid's
Mamba2 heads and the xLSTM's heads over "model", e.g. ``--arch
xlstm-1.3b --data 2 --model 2``, or with ``--model`` a multiple of the
xLSTM's heads each head's columns split; a ``--batch`` below ``--data``
whole on every data rank, a dense or ring KV cache then split over the
data ranks by sequence, e.g. ``--arch zamba2-2.7b --batch 1 --data 2``).
Run outside a process
group, the launcher spawns its ``data x model`` ranks itself (gloo on the
CPU or when ranks share a card, NCCL when each has its own), having
built the kernels once first; run inside one (``torchrun``), it serves as
its rank.  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.runtime.cli import add_serve_options


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--approx", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--data", type=int, default=0,
                    help="mesh data-axis size (0 = no mesh, one device)")
    ap.add_argument("--model", type=int, default=1,
                    help="mesh model-axis size (with --data)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    add_serve_options(ap, batch=4, max_len=128)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.data:
        return _serve(args)
    import torch.distributed as dist
    if dist.is_initialized():
        return _serve(args)
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import spawn_world
    device = resolve_device(args.device)
    world = args.data * args.model
    backend = "gloo"
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
        if torch.cuda.device_count() >= world:
            backend = "nccl"
    spawn_world(_rank_main, world, (args,), backend=backend)


def _rank_main(rank, args):
    _serve(args)


def _serve(args):
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request

    device = resolve_device(args.device)
    mesh, lead = None, True
    if args.data:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh
        if device.type == "cuda":
            device = torch.device("cuda", dist.get_rank()
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        mesh = make_host_mesh(data=args.data, model=args.model)
        lead = dist.get_rank() == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    options = ServeOptions.from_args(args, mesh=mesh)
    if args.approx or options.use_mcma_dispatch:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True,
            library_size=options.library.library_size
            if options.library else cfg.approx.library_size))
    params = M.init_model(args.seed, cfg, device=device, mesh=mesh)
    server = DecodeServer(cfg, params, options=options)
    out = print if lead else (lambda *a, **k: None)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32), max_new=args.max_new)
            for i in range(args.requests)]
    if options.qos_tiers:
        # a mixed-tier wave: the tier table's bounds and the default tier
        choices = list(server.tier_bounds) + [None]
        for i, r in enumerate(reqs):
            r.error_bound = choices[i % len(choices)]
    for r in reqs:
        server.submit(r)
    stats = server.run_until_drained()
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    out(f"served {done}/{len(reqs)} requests, {toks} tokens, "
          f"{stats['ticks']} ticks ({stats['prefill_ticks']} prefill, "
          f"chunk={server.prefill_chunk}) on {device}, "
          f"{stats['wall_s']:.1f}s "
          f"({toks / max(stats['wall_s'], 1e-9):.1f} tok/s aggregate)")
    if "page_hwm" in stats:
        out(f"KV pages: high-water {stats['page_hwm']} of "
              f"{server.n_pages}, {stats['alloc_failures']} admission "
              f"deferrals, page_util {stats['page_util']:.3f}, "
              f"{stats['kv_bytes_resident']} B resident at peak")
    if mesh is not None:
        out(f"mesh: data={args.data} model={args.model} "
            f"({mesh.backend}, {args.data * args.model} ranks)")
    if "invocation_rate" in stats:
        out(f"mean invocation rate: {stats['invocation_rate']:.3f}")
    if "served_invocation_rate" in stats:
        out(f"served invocation rate: {stats['served_invocation_rate']:.3f}"
              f" (dropped {stats['dropped_rows']:.1f} rows,"
              f" frac {stats['dropped_frac']:.4f})")
    for p in stats.get("per_tier", ()):
        out(f"tier {p['tier']} (bound {p['error_bound']:.3f}, margin "
              f"{p['margin']:+.2f}): {p['rows']:.0f} rows, routed "
              f"invocation {p['routed_invocation_rate']:.3f}, served "
              f"{p['served_invocation_rate']:.3f}, dropped_frac "
              f"{p['dropped_frac']:.4f}")
    if "residency" in stats:
        r = stats["residency"]
        out(f"residency: final hot set {r['final_residency']} after "
              f"{r['swap_count']} swaps (off-set exact rows "
              f"{stats['off_set_exact_rows']:.1f})")
        for s in r["swaps"]:
            out(f"  tick {s['tick']}: slot {s['slot']} {s['demoted']} -> "
                  f"{s['promoted']} (EMA {s['cold_ema']:.3f} -> "
                  f"{s['hot_ema']:.3f})")
    if "autotune" in stats:
        a = stats["autotune"]
        out(f"autotune: final rung {a['final_index']} "
              f"{a['final_point']} after {len(a['switches'])} switches")
        for s in a["switches"]:
            out(f"  tick {s['tick']}: rung {s['from_index']} -> "
                  f"{s['to_index']} (drop EMA {s['drop_ema']:.4f})")
        if server.routed_history:
            out("ladder_from_counts (the served class-count quantiles "
                  "as per-class rungs for the next deployment):")
            for pt in server.derived_ladder():
                out(f"  exact_frac={pt.exact_frac:.3f} invoke_fracs="
                      f"{tuple(round(f, 3) for f in pt.invoke_fracs)}")
    if done != len(reqs):
        raise RuntimeError(f"server failed to drain: {done}/{len(reqs)}")
    return stats


if __name__ == "__main__":
    main()
