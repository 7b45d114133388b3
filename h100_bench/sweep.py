"""Find a cell's knee once: the highest arrival rate its server sustains
without a growing queue.  One process builds the model once and serves
the cell's mix at each listed rate on a fresh server, for the mix's
pre-roll and then ``--seconds``, and prints one JSON line a rate.

    python3 h100_bench/sweep.py --workload <cell> --seed <n> \
        --seconds <s> --rates 2,3,4,5
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from h100_bench import run as bench_run  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    bench_run._env()
    import numpy as np
    import torch
    from h100_bench import harness, stats, traffic
    from h100_bench import weights as W
    from repro_torch.models import model as M
    from repro_torch.runtime.server import DecodeServer, Request
    assert torch.cuda.is_available()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_grad_enabled(False)
    cell = harness.load_cell(args.workload)
    cfg_d, mix = harness.cell_config(cell), cell["traffic"]
    dev = torch.device("cuda:0")
    cfg = harness.port_config(cfg_d)
    model = M.init_model(None, cfg, device=dev)
    harness.load_weights(model, W.draw(cfg_d, args.seed, dev, cfg.pdtype))
    for rate in [float(r) for r in args.rates.split(",")]:
        srv = DecodeServer(cfg, model,
                           options=harness.serve_options(cfg_d, mix))
        harness.warm(srv, cfg_d["vocab"], np.random.default_rng(1), Request)
        plan = traffic.schedule(mix, cfg_d["vocab"], args.seed, args.seconds,
                                rate=rate)
        rec = harness.Recorder(srv)
        torch.cuda.synchronize()
        w0 = time.perf_counter() + mix["preroll_s"]
        w1 = w0 + args.seconds
        harness.drive(srv, plan, rec, w0, w1, Request)
        reqs = list(rec.reqs.values())
        inside = [k for k, t in enumerate(rec.times) if t[0] >= w0]
        q = np.asarray([rec.queued[k] for k in inside], float)
        tt = np.asarray([rec.times[k][0] - w0 for k in inside])
        slope = float(np.polyfit(tt, q, 1)[0]) if len(q) > 2 else None
        ttft = stats.ttft_values([r.due for r in reqs],
                                 [r.tokens[0] if r.tokens else None
                                  for r in reqs], w0, w1)
        phases = [rec.times[k][2] for k in inside]
        print(json.dumps(dict(
            rate=rate, due=len(ttft),
            done=sum(1 for r in reqs if r.req.done
                     and w0 <= r.tokens[-1] < w1),
            tokens_per_s=stats.output_tokens_per_s(
                [r.tokens for r in reqs], w0, w1),
            ttft_p50_ms=1e3 * float(np.median(ttft)) if ttft else None,
            ttft_p95_ms=1e3 * stats.p95(ttft) if ttft else None,
            itl_p95_ms=1e3 * (stats.p95(stats.itl_values(
                [r.tokens for r in reqs], w0, w1)) or 0),
            queue_start=int(q[0]) if len(q) else None,
            queue_end=int(q[-1]) if len(q) else None,
            queue_slope_per_s=slope,
            busy_slots_mean=float(np.mean([len(t.rows) for k, t in
                                           enumerate(rec.ticks)
                                           if k in set(inside)])),
            ticks=len(inside), prefill_ticks=phases.count("prefill"),
            decode_ms=1e3 * float(np.mean([rec.times[k][1] - rec.times[k][0]
                                           for k in inside
                                           if rec.times[k][2] == "decode"]
                                          or [0])),
            prefill_ms=1e3 * float(np.mean([rec.times[k][1] - rec.times[k][0]
                                            for k in inside
                                            if rec.times[k][2] == "prefill"]
                                           or [0])))), flush=True)
        del srv, rec
        gc.collect()                    # the server holds cycles
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
