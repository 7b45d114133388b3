"""Serving flags for the port's CLI entry points (counterpart of
``repro/runtime/cli.py``), limited to the features the port serves:

    ap = argparse.ArgumentParser()
    add_serve_options(ap, batch=4, max_len=128)
    options = ServeOptions.from_args(ap.parse_args(argv))

Flags of the reference's features not ported yet (autotune, QoS, library)
join here with those features.
"""
from __future__ import annotations

import argparse


def add_serve_options(parser: argparse.ArgumentParser,
                      **defaults) -> argparse.ArgumentParser:
    """Register the serving flags as one argument group; ``defaults``
    override per-flag defaults for the calling surface."""
    g = parser.add_argument_group(
        "serving", "DecodeServer deployment (runtime/options.ServeOptions)")
    g.add_argument("--batch", type=int, default=8,
                   help="decode slot-table size")
    g.add_argument("--max-len", type=int, default=512,
                   help="per-slot KV-cache length (prompt + generated)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--mcma-dispatch", action="store_true",
                   help="serve the ApproxFFN through the weight-switch "
                        "dispatch engine (implies --approx)")
    g.add_argument("--backend", choices=("pallas", "pallas_fused", "xla"),
                   default=None,
                   help="dispatch executor: pallas = the switched CUDA "
                        "kernel (default), pallas_fused = the fused CUDA "
                        "kernel, xla = the eager oracle")
    g.add_argument("--route-scope", choices=("layer", "tick"), default=None,
                   help="MCMA routing granularity: 'tick' makes ONE "
                        "dispatch plan per tick (reused by every layer); "
                        "'layer' routes per layer (default: the config's "
                        "route_scope)")
    g.add_argument("--prefill-chunk", type=int, default=16,
                   help="chunked prefill: S prompt tokens per prefill "
                        "tick, interleaved with decode ticks (0 = token "
                        "by token; the xLSTM family always feeds token by "
                        "token)")
    g.add_argument("--admission", choices=("cost", "fifo"), default="cost",
                   help="queue admission: 'cost' = prompt length with "
                        "aging (default), 'fifo' = strict arrival order")
    g.add_argument("--overflow", choices=("reject", "trim"),
                   default="reject",
                   help="submit-time policy when prompt + max_new exceeds "
                        "max_len: reject loudly (default) or keep the "
                        "prompt's last max_len - max_new tokens")
    g.add_argument("--aging", type=float, default=0.05,
                   help="cost-admission aging rate (starvation guard)")
    g.add_argument("--kv-page-size", type=int, default=0,
                   help="paged KV cache: page length in tokens (must "
                        "divide --max-len; admission then prices pages; 0 "
                        "= the dense (batch, max_len) layout)")
    g.add_argument("--kv-pages", type=int, default=0,
                   help="page-pool size with --kv-page-size (0 = batch x "
                        "max_len / page size)")
    if defaults:
        known = {a.dest for a in parser._actions}
        unknown = set(defaults) - known
        assert not unknown, f"add_serve_options: unknown defaults {unknown}"
        parser.set_defaults(**defaults)
    return parser
