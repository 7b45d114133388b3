"""Batched decoding with continuous batching on the PyTorch port: the
twin of ``examples/serve_decode.py``.

Loads a reduced config of an assigned architecture, submits a wave of
requests with staggered lengths, and drains them through the slot-table
decode server — per-slot cache positions, slot recycling, and
(optionally) the MCMA ApproxFFN serve path with capacity dispatch.  Runs
on the GPU unless ``--device cpu``.

    python3 examples/serve_decode_torch.py --arch mixtral-8x7b
    python3 examples/serve_decode_torch.py --approx
    python3 examples/serve_decode_torch.py --approx --mcma-dispatch
    python3 examples/serve_decode_torch.py --library-size 8 --n-resident 2

Serving flags are the shared ``runtime/cli.add_serve_options`` inventory
folded into a ``ServeOptions``, the same surface as launch/serve.py.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime.cli import add_serve_options  # noqa: E402
from repro_torch.runtime.options import ServeOptions  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--approx", action="store_true",
                    help="serve through the MCMA ApproxFFN capacity path")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    add_serve_options(ap, batch=4, max_len=96)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = smoke_config(get_config(args.arch))
    options = ServeOptions.from_args(args)
    if args.approx or options.use_mcma_dispatch:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True,
            library_size=options.library.library_size
            if options.library else cfg.approx.library_size))
    assert cfg.input_mode == "tokens", "serve demo expects token models"
    params = M.init_model(0, cfg, device=dev)
    server = DecodeServer(cfg, params, options=options)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 20))
        eb = None
        if options.qos_tiers:   # cycle tight / default / loose / unspecified
            eb = (list(server.tier_bounds) + [None])[
                i % (len(server.tier_bounds) + 1)]
        reqs.append(Request(rid=i,
                            prompt=rng.integers(0, cfg.vocab, plen)
                            .astype(np.int32),
                            max_new=int(rng.integers(8, 24)),
                            error_bound=eb))
        server.submit(reqs[-1])
    stats = server.run_until_drained()
    for r in reqs[:4]:
        print(f"req {r.rid}: prompt_len={len(r.prompt)} -> "
              f"{len(r.out)} new tokens: {r.out[:8]}...")
    done = sum(r.done for r in reqs)
    path = ("MCMA-dispatch" if options.use_mcma_dispatch
            else "approx-FFN" if args.approx else "exact-FFN")
    print(f"\n{done}/{len(reqs)} requests served in {stats['ticks']} ticks "
          f"({stats['prefill_ticks']} prefill, chunk={server.prefill_chunk}) "
          f"with a {args.batch}-slot table ({path} path)")
    ttft = [r.first_token_tick - r.arrival_tick for r in reqs
            if r.first_token_tick is not None]
    if ttft:
        print(f"ttft: mean {np.mean(ttft):.1f} ticks, max {max(ttft)}")
    if "invocation_rate" in stats:
        print(f"mean invocation rate (fraction of tokens approximated): "
              f"{stats['invocation_rate']:.3f}")
    if "served_invocation_rate" in stats:
        print(f"served invocation rate (approx rows executed): "
              f"{stats['served_invocation_rate']:.3f}; dropped "
              f"{stats['dropped_rows']:.1f} rows")
    if "per_tier" in stats:
        for p in stats["per_tier"]:
            print(f"tier {p['tier']} (bound {p['error_bound']:.3f}): "
                  f"served invocation {p['served_invocation_rate']:.3f} "
                  f"over {p['rows']:.0f} rows")
    if "residency" in stats:
        r = stats["residency"]
        print(f"residency: final hot set {r['final_residency']} after "
              f"{r['swap_count']} swaps "
              f"(off-set exact rows {stats['off_set_exact_rows']:.1f})")
    if "autotune" in stats:
        a = stats["autotune"]
        print(f"autotune: {len(a['switches'])} switches, final point "
              f"{a['final_point']}")
    assert done == len(reqs)
    return stats


if __name__ == "__main__":
    main()
