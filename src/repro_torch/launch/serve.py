"""Serving launcher: batched decode with the continuous-batching server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --approx --mcma-dispatch [--backend pallas_fused] \\
        [--route-scope tick] [--prefill-chunk 64] \\
        [--kv-page-size 16 [--kv-pages 128]] [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
        [--smoke] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; the weights are random,
from ``--seed``.  Prompts load ``--prefill-chunk`` tokens per prefill
tick (default 16, as the reference's CLI; 0 = token by token; the xLSTM
family always feeds token by token).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.runtime.cli import add_serve_options


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--approx", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    add_serve_options(ap, batch=4, max_len=128)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    options = ServeOptions.from_args(args)
    if args.approx or options.use_mcma_dispatch:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    params = M.init_model(args.seed, cfg, device=device)
    server = DecodeServer(cfg, params, options=options)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32), max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        server.submit(r)
    stats = server.run_until_drained()
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    print(f"served {done}/{len(reqs)} requests, {toks} tokens, "
          f"{stats['ticks']} ticks ({stats['prefill_ticks']} prefill, "
          f"chunk={server.prefill_chunk}) on {device}, "
          f"{stats['wall_s']:.1f}s "
          f"({toks / max(stats['wall_s'], 1e-9):.1f} tok/s aggregate)")
    if "page_hwm" in stats:
        print(f"KV pages: high-water {stats['page_hwm']} of "
              f"{server.n_pages}, {stats['alloc_failures']} admission "
              f"deferrals, page_util {stats['page_util']:.3f}, "
              f"{stats['kv_bytes_resident']} B resident at peak")
    if "invocation_rate" in stats:
        print(f"mean invocation rate: {stats['invocation_rate']:.3f}")
    if "served_invocation_rate" in stats:
        print(f"served invocation rate: {stats['served_invocation_rate']:.3f}"
              f" (dropped {stats['dropped_rows']:.1f} rows,"
              f" frac {stats['dropped_frac']:.4f})")
    if done != len(reqs):
        raise RuntimeError(f"server failed to drain: {done}/{len(reqs)}")
    return stats


if __name__ == "__main__":
    main()
