"""Serving flags for the port's CLI entry points (counterpart of
``repro/runtime/cli.py``, the same flag inventory):

    ap = argparse.ArgumentParser()
    add_serve_options(ap, batch=4, max_len=128)
    options = ServeOptions.from_args(ap.parse_args(argv))

``add_serve_options`` only registers flags; the implication chain
(--qos-app and --tier-bounds imply --qos; --qos, --autotune and a library
imply --mcma-dispatch) lives in ``ServeOptions.from_args``.
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
    g.add_argument("--autotune", action="store_true",
                   help="adapt serve capacities online from the served "
                        "invoke stats (runtime/autotune.py; implies "
                        "--mcma-dispatch): the controller walks a ladder "
                        "of operating points, one step each, targeting "
                        "--drop-budget dropped rows")
    g.add_argument("--drop-budget", type=float, default=0.05,
                   help="autotune target: max fraction of routed rows "
                        "dropped over capacity (default 0.05)")
    g.add_argument("--qos", action="store_true",
                   help="per-request QoS tiers (implies --mcma-dispatch): "
                        "each request carries an error_bound, validated "
                        "and snapped onto the tier table at submit time")
    g.add_argument("--qos-app", default=None,
                   help="apps/registry.py app whose error bound anchors "
                        "the QoS tier table (implies --qos; default "
                        "anchor: the config's approx.error_bound)")
    g.add_argument("--tier-bounds", default=None,
                   help="comma-separated ascending error bounds "
                        "overriding the default (tight, base, loose) "
                        "tier table, e.g. 0.05,0.1,0.2")
    g.add_argument("--library-size", type=int, default=0,
                   help="approximator-library residency (implies "
                        "--mcma-dispatch): serve a library of this many "
                        "approximators with --n-resident of them "
                        "resident, swapped by the ResidencyController "
                        "(0 = off, every approximator resident)")
    g.add_argument("--n-resident", type=int, default=0,
                   help="resident slots with --library-size (0 = "
                        "min(4, library_size))")
    g.add_argument("--prefill-chunk", type=int, default=16,
                   help="chunked prefill: S prompt tokens per prefill "
                        "tick, interleaved with decode ticks (0 = token "
                        "by token; the xLSTM family always feeds token by "
                        "token)")
    g.add_argument("--admission", choices=("cost", "fifo"), default="cost",
                   help="queue admission: 'cost' = prompt length x QoS "
                        "tier multiplier with aging (default), 'fifo' = "
                        "strict arrival order")
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
