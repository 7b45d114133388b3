"""Drive the PyTorch/CUDA port on one GPU, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per source, in parallel);
  3. each kernel against its PyTorch version on the card, over the sweeps
     of tests/test_kernels.py and the decode path's full-width shape, in
     float32 (tolerance 3e-5) and bfloat16 (2e-2); the fused kernel must
     equal the switched one bitwise; kernel and PyTorch version timed
     with CUDA events;
  4. full-width internlm2-1.8b (24 layers, bf16, random weights from a
     seed, MCMA dispatch) served through DecodeServer with backends
     "pallas" then "pallas_fused": equal greedy tokens, and each kernel
     launched 24 times per decode tick; then one decode step through all
     three backends from one cache, held to the "xla" oracle: in float32
     (the same weights upcast) within 1e-4 with equal greedy tokens, and
     in bf16 through an oracle given the kernels' rounding;
  5. the smoke config in float32 on the card against the same parameters
     served on the CPU by the eager oracle;
  6. a JSON line describing every kernel, then the result line.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # outside the tensor cores
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SERVE = dict(batch=8, max_len=256, n_requests=8, prompt_len=16, max_new=16)


def log(msg):
    print(msg, flush=True)


def check_kernels(torch, x, cls, w, block, dtype, name):
    """Each kernel vs its PyTorch version; returns ({kernel: max |kernel -
    plain|}, the kernels' operands)."""
    from repro_torch.kernels import fused_dispatch, ops, ref, switched_mlp
    xp, rows, tile_cls, weights, order, pos = ops.kernel_operands(
        x, cls, *w, block_t=block)
    y = switched_mlp.switched_mlp(xp, tile_cls, *weights, block_t=block)
    yf = fused_dispatch.switched_mlp_fused(x, rows, tile_cls, *weights,
                                           block_t=block)
    plain = switched_mlp.switched_mlp_plain(xp, tile_cls, *weights,
                                            block_t=block)
    plain_f = fused_dispatch.switched_mlp_fused_plain(
        x, rows, tile_cls, *weights, block_t=block)
    torch.cuda.synchronize()
    t = x.shape[0]
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), plain.float(), rtol=tol, atol=tol,
                               msg=f"switched_mlp {name} {dtype}")
    torch.testing.assert_close(yf[:t].float(), plain_f[:t].float(), rtol=tol,
                               atol=tol, msg=f"fused {name} {dtype}")
    unsorted = y[pos.long()][torch.argsort(order.long())]
    if not torch.equal(yf[:t], unsorted):
        raise AssertionError(f"fused != switched bitwise ({name} {dtype})")
    d_out = w[2].shape[2]
    whole = ops.switched_apply(x, cls, *w, block_t=block)
    want = ref.switched_mlp_ref(x, cls, *w)
    torch.testing.assert_close(whole.float(), want.float(), rtol=tol,
                               atol=tol, msg=f"switched_apply {name} {dtype}")
    assert whole.shape == (t, d_out)
    err = {"switched_mlp": (y.float() - plain.float()).abs().max().item(),
           "switched_mlp_fused":
               (yf[:t].float() - plain_f[:t].float()).abs().max().item()}
    return err, (xp, rows, tile_cls, weights)


def sweep_inputs(torch, case, dtype):
    from repro_torch.kernels.sweeps import case_inputs
    x, cls, w, block = case_inputs(case)
    to = dict(device="cuda", dtype=getattr(torch, dtype))
    return (torch.from_numpy(x).to(**to), torch.from_numpy(cls).cuda(),
            [torch.from_numpy(a).to(**to) for a in w], block)


def time_ms(torch, fn, flush, iters=30):
    """Median ms of one call, each run after flushing the L2 cache (the
    decode path meets every layer's weights cold), timed with CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(dtype, n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main_path_kernel_phase(np, torch, flush):
    """Both kernels at the decode path's full-width shape: one layer's
    dispatch of 8 rows over 3 approximators + the zero pseudo-class,
    d=2048, d_hidden=256, block_t=128, bf16 and float32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import fused_dispatch, switched_mlp
    cfg = get_config("internlm2-1.8b")
    a = cfg.approx
    n, d, dh, t = a.n_approx + 1, cfg.d_model, a.d_hidden, SERVE["batch"]
    rng = np.random.default_rng(7)
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        to = dict(device="cuda", dtype=dt)
        x = torch.from_numpy(rng.normal(size=(t, d))).to(**to)
        w = [torch.from_numpy(rng.normal(size=s) * sc).to(**to) for s, sc in (
            ((n, d, dh), d ** -0.5), ((n, dh), 0.1), ((n, dh, d), dh ** -0.5),
            ((n, d), 0.1))]
        for arr in w:
            arr[-1] = 0                         # the zero pseudo-class
        cls = torch.from_numpy(rng.integers(0, n, t).astype(np.int32)).cuda()
        err, (xp, rows, tile_cls, weights) = check_kernels(
            torch, x, cls, w, a.block_t, dtype, "main_path")
        blk = a.block_t
        classes = torch.unique(tile_cls).tolist()
        w_bytes = sum(wt[c].numel() * wt.element_size()
                      for c in classes for wt in weights)
        flops = tile_cls.numel() * blk * 2 * (
            weights[0].shape[1] * weights[0].shape[2]
            + weights[2].shape[1] * weights[2].shape[2])
        d_out_p = weights[2].shape[2]
        esz = xp.element_size()
        sw_bytes = xp.numel() * esz + 4 * tile_cls.numel() + w_bytes \
            + xp.shape[0] * d_out_p * esz
        fu_bytes = x.numel() * esz + 4 * (rows.numel() + tile_cls.numel()) \
            + w_bytes + (t + 1) * d_out_p * esz
        run = {
            "switched_mlp": (
                lambda: switched_mlp.switched_mlp(xp, tile_cls, *weights,
                                                  block_t=blk),
                lambda: switched_mlp.switched_mlp_plain(
                    xp, tile_cls, *weights, block_t=blk), sw_bytes),
            "switched_mlp_fused": (
                lambda: fused_dispatch.switched_mlp_fused(
                    x, rows, tile_cls, *weights, block_t=blk),
                lambda: fused_dispatch.switched_mlp_fused_plain(
                    x, rows, tile_cls, *weights, block_t=blk), fu_bytes),
        }
        for name, (kern, plain, n_bytes) in run.items():
            # plain, kernel, kernel, plain: compare within one call
            p1 = time_ms(torch, plain, flush)
            k1 = time_ms(torch, kern, flush)
            k2 = time_ms(torch, kern, flush)
            p2 = time_ms(torch, plain, flush)
            b_ms, b_by = bound(dtype, n_bytes, flops)
            out[name, dtype] = dict(
                max_abs_err=err[name], ms=min(k1, k2), plain_ms=min(p1, p2),
                bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, flops=flops,
                classes=len(classes))
            log(f"  {name} {dtype} main path (t_pad={xp.shape[0]}, "
                f"{len(classes)} classes): kernel {k1:.4f}/{k2:.4f} ms, "
                f"plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                f"{n_bytes} B, {flops} FLOP), max |kernel-plain| "
                f"{err[name]:.3g}")
    return out


def serve_full_width(np, torch):
    """Serve full-width internlm2-1.8b through DecodeServer on both kernel
    backends; returns per-backend results and the server of the first."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import fused_dispatch, switched_mlp
    from repro_torch.models import model as M
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  init {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"GQA {cfg.n_heads}/{cfg.n_kv_heads}, d_ff={cfg.d_ff}, "
        f"vocab={cfg.vocab}, {cfg.param_dtype}, {n_params} parameters in "
        f"{time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, SERVE["prompt_len"]).astype(np.int32)
               for _ in range(SERVE["n_requests"])]
    kernels = {"pallas": switched_mlp.switched_mlp,
               "pallas_fused": fused_dispatch.switched_mlp_fused}
    results, first = {}, None
    for backend in ("pallas", "pallas_fused"):
        srv = DecodeServer(cfg, params, options=ServeOptions(
            batch=SERVE["batch"], max_len=SERVE["max_len"],
            use_mcma_dispatch=True, backend=backend))
        reqs = [Request(rid=i, prompt=p, max_new=SERVE["max_new"])
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.time()
        stats = srv.run_until_drained()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {b: k.launches for b, k in kernels.items()}
        if not all(r.done and not r.aborted for r in reqs):
            raise AssertionError(f"{backend}: server did not drain")
        want = cfg.n_layers * stats["ticks"]
        if launches[backend] != want or sum(launches.values()) != want:
            raise AssertionError(f"{backend}: launches {launches}, want "
                                 f"{want} of {backend} alone")
        n_tok = sum(len(r.out) for r in reqs)
        results[backend] = dict(tokens=[r.out for r in reqs],
                                launches=launches[backend],
                                ticks=stats["ticks"], wall_s=wall,
                                tok_s=n_tok / wall,
                                invocation=stats["invocation_rate"])
        log(f"  serve {backend}: {stats['ticks']} decode ticks, {n_tok} "
            f"tokens, {wall * 1e3 / stats['ticks']:.2f} ms/tick, "
            f"{n_tok / wall:.1f} tokens/s, invocation rate "
            f"{stats['invocation_rate']:.4f}, served "
            f"{stats['served_invocation_rate']:.4f}, launches "
            f"{launches[backend]} = {cfg.n_layers} x {stats['ticks']}")
        first = first or (srv, reqs)
    if results["pallas"]["tokens"] != results["pallas_fused"]["tokens"]:
        raise AssertionError("greedy tokens differ between pallas and "
                             "pallas_fused")
    log("  greedy tokens equal across pallas and pallas_fused")
    return cfg, params, results, first


def one_step(torch, cfg, params, base, toks, backends):
    """One decode step from copies of the cache ``base``; returns the
    float32 logits of each backend, checked finite and of shape (B, V)."""
    from repro_torch.runtime import steps
    logits = {}
    for backend in backends:
        step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                      backend=backend)
        cache = {k: v.clone() for k, v in base.items()}
        lg, _ = step(params, cache, toks)
        if lg.shape != (toks.shape[0], cfg.vocab) or \
                not torch.isfinite(lg.float()).all():
            raise AssertionError(f"{backend}: logits {tuple(lg.shape)} "
                                 "not finite or misshapen")
        logits[backend] = lg.float()
    return logits


def kernel_rounding_approximator(xb, w1, b1, w2, b2):
    """The oracle's approximator MLP with the kernels' rounding: products
    and biases summed in float32, ``h`` rounded once to the activation
    type, the result rounded once."""
    import torch
    h = torch.tanh(xb.float() @ w1.float() + b1.float()).to(xb.dtype)
    return (h.float() @ w2.float() + b2.float()).to(xb.dtype)


def oracle_witness(torch, cfg, params, srv, reqs):
    """Hold the full-width decode step to the independent "xla" oracle
    (per-class capacity buffers, no class sort, no kernel).

    bf16: the kernel backends agree bitwise; their gap to the oracle is
    printed, then the oracle is given the kernels' rounding and the gap
    must shrink at least tenfold.  float32 (the same weights upcast, in
    place): logits within 1e-4 of the oracle, greedy tokens equal."""
    from repro_torch.runtime import dispatch
    base = {k: v.clone() for k, v in srv.cache.items()}
    toks = torch.tensor([[r.out[-1]] for r in reqs], dtype=torch.int32,
                        device=base["pos"].device)
    lg = one_step(torch, cfg, params, base, toks,
                  ("xla", "pallas", "pallas_fused"))
    if not torch.equal(lg["pallas"], lg["pallas_fused"]):
        raise AssertionError("pallas and pallas_fused logits differ")
    plain = dispatch.apply_approximator
    dispatch.apply_approximator = kernel_rounding_approximator
    try:
        lg_kr = one_step(torch, cfg, params, base, toks, ("xla",))["xla"]
    finally:
        dispatch.apply_approximator = plain
    gap = (lg["pallas"] - lg["xla"]).abs().max().item()
    gap_kr = (lg["pallas"] - lg_kr).abs().max().item()
    log(f"  one bf16 step from one cache: max |logits - xla| pallas "
        f"{gap:.4g}, pallas_fused "
        f"{(lg['pallas_fused'] - lg['xla']).abs().max().item():.4g}; "
        f"against the oracle with the kernels' rounding {gap_kr:.4g} "
        f"(logits span {lg['xla'].min().item():.3g}.."
        f"{lg['xla'].max().item():.3g})")

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    params.float()
    base32 = {k: v.float() if v.is_floating_point() else v
              for k, v in base.items()}
    lg32 = one_step(torch, cfg32, params, base32, toks,
                    ("xla", "pallas", "pallas_fused"))
    gap32 = (lg32["pallas"] - lg32["xla"]).abs().max().item()
    log(f"  one float32 step, same weights upcast: max |logits - xla| "
        f"pallas {gap32:.4g}, pallas_fused "
        f"{(lg32['pallas_fused'] - lg32['xla']).abs().max().item():.4g} "
        f"(logits span {lg32['xla'].min().item():.3g}.."
        f"{lg32['xla'].max().item():.3g})")
    if not torch.equal(lg32["pallas"], lg32["pallas_fused"]):
        raise AssertionError("float32: pallas and pallas_fused differ")
    for b in ("pallas", "pallas_fused"):
        torch.testing.assert_close(lg32[b], lg32["xla"], rtol=1e-4,
                                   atol=1e-4, msg=f"float32 {b} vs xla")
        if not torch.equal(lg32[b].argmax(-1), lg32["xla"].argmax(-1)):
            raise AssertionError(f"float32 {b}: greedy tokens differ")
    if not gap_kr * 10 <= gap:
        raise AssertionError(f"bf16: the oracle with the kernels' rounding "
                             f"is {gap_kr} from pallas, the plain oracle "
                             f"{gap}")


def smoke_reference_check(np, torch):
    """The float32 smoke config on the card, each backend, against the
    same parameters served on the CPU by the eager oracle: logits within
    1e-4 and greedy tokens equal over 8 ticks."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    cfg = smoke_config(get_config("internlm2-1.8b"))
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    params = M.init_model(0, cfg, device="cuda")
    cpu_params = copy.deepcopy(params).cpu()
    b, max_len, ticks = 8, 16, 8
    mask = torch.tensor([True] * 6 + [False] * 2)
    runs = {}
    for dev, backend in (("cpu", "xla"), ("cuda", "xla"), ("cuda", "pallas"),
                         ("cuda", "pallas_fused")):
        p = cpu_params if dev == "cpu" else params
        step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                      backend=backend)
        cache = M.init_cache(cfg, b, max_len, device=dev)
        toks = torch.arange(1, b + 1, dtype=torch.int32)[:, None]
        out = []
        for _ in range(ticks):
            lg, cache = step(p, cache, toks.to(dev), mask.to(dev))
            out.append(lg.float().cpu())
            toks = lg.argmax(-1).to(torch.int32).cpu()[:, None]
        runs[dev, backend] = torch.stack(out)
    ref = runs["cpu", "xla"]
    worst = 0.0
    for key, lg in runs.items():
        torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4,
                                   msg=f"smoke {key} vs cpu xla")
        if not torch.equal(lg.argmax(-1), ref.argmax(-1)):
            raise AssertionError(f"smoke {key}: greedy tokens differ")
        worst = max(worst, (lg - ref).abs().max().item())
    if not torch.equal(runs["cuda", "pallas"], runs["cuda", "pallas_fused"]):
        raise AssertionError("smoke: pallas and pallas_fused differ")
    log(f"  smoke config f32, {ticks} ticks: every card backend within "
        f"{worst:.3g} of the CPU oracle, greedy tokens equal")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.sweeps import CASES

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("[build]")
    t0 = time.time()
    logs = build.build_all()
    log(f"  built {len(logs)} of {len(build.SOURCES)} kernels in "
        f"{time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[kernels vs plain]")
    for case in sorted(CASES):
        for dtype in ("float32", "bfloat16"):
            x, cls, w, block = sweep_inputs(torch, case, dtype)
            err, _ = check_kernels(torch, x, cls, w, block, dtype, case)
            log(f"  {case} {dtype}: max |kernel-plain| switched "
                f"{err['switched_mlp']:.3g}, fused "
                f"{err['switched_mlp_fused']:.3g}")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timing = main_path_kernel_phase(np, torch, flush)
    del flush

    log("[serve full width]")
    cfg, params, results, (srv, reqs) = serve_full_width(np, torch)
    oracle_witness(torch, cfg, params, srv, reqs)
    del srv, params
    torch.cuda.empty_cache()

    log("[smoke reference]")
    smoke_reference_check(np, torch)

    rows = []
    for name, backend, src, replaces in (
            ("switched_mlp", "pallas", "switched_mlp.cu",
             "src/repro/kernels/switched_mlp.py:37"),
            ("switched_mlp_fused", "pallas_fused", "fused_dispatch.cu",
             "src/repro/kernels/fused_dispatch.py:120")):
        tm = timing[name, "bfloat16"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": results[backend]["launches"],
            "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None})
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
