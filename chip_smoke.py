"""Drive the PyTorch/CUDA port on one GPU, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per source, in parallel), and print what cudaFuncGetAttributes says of
     each launcher of the weight-switch tile routine at the decode shape
     (registers, static and dynamic shared memory, local bytes, cluster)
     and of the sLSTM kernel at xlstm-1.3b width in both weight dtypes
     (the same, with the CTAs of its cooperative grid, CTAs per head and
     units per CTA, and the dynamic shared memory held to the planner's);
  3. each kernel against its PyTorch version on the card, with CUDA-event
     timings (plain, kernel, kernel, plain; L2 flushed before each call):
     the weight-switch kernels over the sweeps of tests/test_kernels.py
     (and 16-row tiles) and the decode path's full-width shape, in
     float32 (tolerance 3e-5) and bfloat16 (2e-2), the fused kernel
     bitwise equal to the switched one; the one-approximator MLP over the
     reference's four shapes and the full-width ApproxFFN shape (same
     tolerances), with ``ops.mlp_apply`` held to ``ref.mlp_forward_ref``;
     the sLSTM recurrence over the reference's three shapes and three
     that meet the edges of its split (1e-5), and xlstm-1.3b's prefill
     and decode shapes (1e-4 with float32 weights, 2e-2 with bfloat16);
  4. full-width internlm2-1.8b (24 layers, bf16, random weights from a
     seed, MCMA dispatch) served through DecodeServer with backends
     "pallas" then "pallas_fused": equal greedy tokens, and each kernel
     launched 24 times per decode tick; then one decode step through all
     three backends from one cache, held to the "xla" oracle: in float32
     (the same weights upcast) within 1e-4 with equal greedy tokens, and
     in bf16 through an oracle given the kernels' rounding;
  5. the internlm2 smoke config in float32 on the card against the same
     parameters served on the CPU by the eager oracle;
  6. full-width xlstm-1.3b (48 layers, bf16, random weights from a seed):
     a (8, 256) prefill launching the sLSTM kernel once per group (6) over
     all 256 steps; DecodeServer serving 8 requests, 6 launches per tick;
     then, in float32 (the same weights upcast), forward over 256 tokens
     read at position 128 against prefill(128) + decode(1) within 2e-3 with
     equal greedy tokens;
  7. the xlstm smoke config in float32 on the card against the same
     parameters on the CPU: prefill 32 tokens, 8 decode ticks, logits
     within 1e-4 and equal greedy tokens;
  8. a JSON line describing every kernel, then the result line.
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
MLP_FULL = (2048, 2048, 256, 2048)   # ApproxFFN rows, d_in, d_hidden, d_out
MLP_BLOCK = 256
# the sLSTM at xlstm-1.3b width: prefill (S = prompt) and decode (S = 1)
SLSTM_FULL = {"prefill": (256, 8, 4, 512), "decode": (1, 8, 4, 512)}
SLSTM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # full width; sweeps 1e-5
# and at batches a larger slot table gives it (checked, not timed)
SLSTM_WIDE_BATCH = [(16, 64, 4, 512), (4, 256, 4, 512)]
XLSTM_PROMPT = (8, 256)              # prefill batch, prompt length
WITNESS = dict(batch=2, seq=256, at=128)


def log(msg):
    print(msg, flush=True)


def kernel_resources(torch):
    """Registers, shared memory, local bytes and cluster width of the three
    launchers of csrc/switch_tile.cuh, in both dtypes, at the decode
    path's shape (d_h_p 256, d_out_p 2048, block_t 128); then the sLSTM
    kernel's at xlstm-1.3b width (batch 8) with its cooperative grid."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.models.xlstm import slstm_dims
    cfg = get_config("internlm2-1.8b")
    for name, src in (("switched_mlp", "switched_mlp"),
                      ("switched_mlp_fused", "fused_dispatch"),
                      ("mlp_forward", "mcma_mlp")):
        for dtype in ("float32", "bfloat16"):
            r = build.resources(src, f"{name}_resources", (
                int(dtype == "bfloat16"), cfg.approx.d_hidden, cfg.d_model,
                cfg.approx.block_t))
            log(f"  {name} {dtype}: {r['registers']} registers/thread, "
                f"{r['static_smem']} B static + {r['dynamic_smem']} B "
                f"dynamic shared memory, {r['local_bytes']} B local, "
                f"cluster of {r['cluster']}")
    _, h, hd = slstm_dims(get_config("xlstm-1.3b"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in ("float32", "bfloat16"):
        r = K.resources(SLSTM_FULL["prefill"][1], h, hd,
                        getattr(torch, dtype))
        log(f"  slstm_scan wh {dtype}: {r['registers']} registers/thread, "
            f"{r['static_smem']} B static + {r['dynamic_smem']} B dynamic "
            f"shared memory, {r['local_bytes']} B local; cooperative grid "
            f"of {r['grid']} CTAs ({r['ctas_per_head']} per head, "
            f"{r['units']} units each, {r['chunks']} chunk(s) of batch rows "
            f"a step), {r['ctas_per_sm']} CTA/SM x {n_sm} SMs")
        if r["dynamic_smem"] != r["plan_smem"] or \
                r["ctas_per_sm"] * n_sm < r["grid"]:
            raise AssertionError(f"slstm_scan {dtype}: the planner's "
                                 f"layout or grid disagrees with the kernel "
                                 f"({r})")


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
            ms, plain_ms, (p1, k1, k2, p2) = timed_pair(torch, kern, plain,
                                                        flush)
            b_ms, b_by = bound(dtype, n_bytes, flops)
            out[name, dtype] = dict(
                max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)
            log(f"  {name} {dtype} main path (t_pad={xp.shape[0]}, "
                f"{len(classes)} classes): kernel {k1:.4f}/{k2:.4f} ms, "
                f"plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                f"{n_bytes} B, {flops} FLOP), max |kernel-plain| "
                f"{err[name]:.3g}")
    return out


def timed_pair(torch, kern, plain, flush, iters=30):
    """plain, kernel, kernel, plain (two versions are compared only within
    one call); returns (kernel ms, plain ms, the four medians)."""
    p1 = time_ms(torch, plain, flush, iters)
    k1 = time_ms(torch, kern, flush, iters)
    k2 = time_ms(torch, kern, flush, iters)
    p2 = time_ms(torch, plain, flush, iters)
    return min(k1, k2), min(p1, p2), (p1, k1, k2, p2)


def max_err(torch, got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def mlp_kernel_phase(np, torch, flush):
    """mlp_forward against its PyTorch version over the reference's
    shapes and the full-width ApproxFFN shape (timed there); then the
    user entry point ops.mlp_apply against ref.mlp_forward_ref, the run
    whose launches the kernels line reports."""
    from repro_torch.kernels import mcma_mlp, ops, ref
    from repro_torch.kernels.sweeps import MLP_SHAPES, mlp_inputs
    rng = np.random.default_rng(11)
    t, d_in, d_h, d_out = MLP_FULL
    full = [rng.normal(size=(t, d_in)), rng.normal(size=(d_in, d_h))
            * d_in ** -0.5, rng.normal(size=d_h) * 0.1,
            rng.normal(size=(d_h, d_out)) * d_h ** -0.5,
            rng.normal(size=d_out) * 0.1]
    cases = [(shape, mlp_inputs(*shape), 128) for shape in MLP_SHAPES]
    cases.append((MLP_FULL, full, MLP_BLOCK))
    out, entry = {}, []
    for dtype in ("float32", "bfloat16"):
        to = dict(device="cuda", dtype=getattr(torch, dtype))
        for shape, arrays, blk in cases:
            a = [torch.from_numpy(np.asarray(v)).to(**to) for v in arrays]
            operands = ops.mlp_operands(*a, block_t=blk)
            kern = lambda: mcma_mlp.mlp_forward(*operands, block_t=blk)
            plain = lambda: mcma_mlp.mlp_forward_plain(*operands,
                                                       block_t=blk)
            y, want = kern(), plain()
            torch.cuda.synchronize()
            tol = TOL[dtype]
            torch.testing.assert_close(y.float(), want.float(), rtol=tol,
                                       atol=tol,
                                       msg=f"mlp_forward {shape} {dtype}")
            err = max_err(torch, [y], [want])
            entry.append((shape, a, blk, dtype))
            if shape != MLP_FULL:
                log(f"  mlp_forward {shape} {dtype}: max |kernel-plain| "
                    f"{err:.3g}")
                continue
            ms, plain_ms, four = timed_pair(torch, kern, plain, flush)
            esz = a[0].element_size()
            n_bytes = sum(o.numel() for o in operands) * esz + t * d_out * esz
            flops = 2 * t * (d_in * d_h + d_h * d_out)
            b_ms, b_by = bound(dtype, n_bytes, flops)
            out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by)
            log(f"  mlp_forward {shape} {dtype} block_t {blk}: kernel "
                f"{four[1]:.4f}/{four[2]:.4f} ms, plain {four[0]:.4f}/"
                f"{four[3]:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {n_bytes} "
                f"B, {flops} FLOP), max |kernel-plain| {err:.3g}")
    # the entry point on the reference's shapes, as tests/test_kernels.py
    # holds it (the reference's ref does not round h: bf16 tolerance)
    torch.cuda.synchronize()
    entry = [e for e in entry if e[0] != MLP_FULL]
    mcma_mlp.mlp_forward.launches = 0
    for shape, a, blk, dtype in entry:
        y = ops.mlp_apply(*a, block_t=blk)
        want = ref.mlp_forward_ref(*a)
        tol = TOL[dtype]
        torch.testing.assert_close(y.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"mlp_apply {shape} {dtype}")
        if y.shape != (shape[0], shape[3]):
            raise AssertionError(f"mlp_apply {shape}: shape {y.shape}")
    torch.cuda.synchronize()
    out["launches"] = mcma_mlp.mlp_forward.launches
    if out["launches"] != len(entry):
        raise AssertionError(f"mlp_apply launched mlp_forward "
                             f"{out['launches']} times, want {len(entry)}")
    log(f"  ops.mlp_apply vs ref.mlp_forward_ref on {out['launches']} "
        f"shape x dtype cases: within tolerance, {out['launches']} launches")
    return out


def slstm_kernel_phase(np, torch, flush):
    """slstm_scan against its PyTorch version over the sweeps (1e-5),
    xlstm-1.3b's prefill and decode shapes (timed) and its width at larger
    batches, with float32 and bfloat16 recurrent weights."""
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.kernels.sweeps import SLSTM_SHAPES, slstm_inputs
    out = {}
    cases = [(s, slstm_inputs(*s), None) for s in SLSTM_SHAPES]
    cases += [(s, slstm_inputs(*s, wh_scale=s[3] ** -0.5), name)
              for name, s in SLSTM_FULL.items()]
    cases += [(s, slstm_inputs(*s, wh_scale=s[3] ** -0.5), "wide")
              for s in SLSTM_WIDE_BATCH]
    for wdtype in ("float32", "bfloat16"):
        for shape, arrays, name in cases:
            xg, wh, *st = [torch.from_numpy(v).cuda() for v in arrays]
            wh = wh.to(getattr(torch, wdtype))
            kern = lambda: K.slstm_scan(xg, wh, *st)
            plain = lambda: K.slstm_scan_plain(xg, wh, *st)
            (ys, fin), (pys, pfin) = kern(), plain()
            torch.cuda.synchronize()
            tol = SLSTM_TOL[wdtype] if name else 1e-5
            for g, w, what in zip((ys, *fin), (pys, *pfin),
                                  ("ys", "h", "c", "n", "m")):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"slstm_scan {shape}: {what} not "
                                         "finite")
                torch.testing.assert_close(
                    g, w, rtol=tol, atol=tol,
                    msg=f"slstm_scan {shape} {wdtype} {what}")
            err = max_err(torch, (ys, *fin), (pys, *pfin))
            if name in (None, "wide"):
                log(f"  slstm_scan {shape} wh {wdtype}: max |kernel-plain| "
                    f"{err:.3g}")
                continue
            ms, plain_ms, four = timed_pair(torch, kern, plain, flush,
                                            iters=10)
            s, b, h, hd = shape
            n_bytes = (xg.numel() + ys.numel() + 8 * b * h * hd) * 4 \
                + wh.numel() * wh.element_size()
            flops = 2 * s * b * h * hd * 4 * hd
            b_ms, b_by = bound(wdtype, n_bytes, flops)
            out[name, wdtype] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            log(f"  slstm_scan {name} {shape} wh {wdtype}: kernel "
                f"{four[1]:.4f}/{four[2]:.4f} ms, plain {four[0]:.4f}/"
                f"{four[3]:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {n_bytes} "
                f"B, {flops} FLOP), max |kernel-plain| {err:.3g}")
    return out


class StepRecorder:
    """Wraps the model's sLSTM entry to record each call's step count S
    (the wrapper's own launch counter still counts every launch)."""

    def __init__(self):
        from repro_torch.models import xlstm
        self.mod, self.real, self.steps = xlstm, xlstm.slstm_scan, []

    def __enter__(self):
        def rec(xg, *a):
            self.steps.append(xg.shape[0])
            return self.real(xg, *a)
        self.mod.slstm_scan = rec
        return self

    def __exit__(self, *exc):
        self.mod.slstm_scan = self.real


def serve_xlstm(np, torch):
    """Full-width xlstm-1.3b: prefill, DecodeServer, and the float32
    forward vs prefill + decode witness.  Returns the launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))  # MCMA dispatch on: no ApproxFFN, rate 0
    groups = M.topology(cfg).n_groups
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  init {cfg.name}: {cfg.n_layers} layers ({groups} groups of "
        f"{cfg.ssm.slstm_every - 1} mLSTM + 1 sLSTM), d={cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab={cfg.vocab}, {cfg.param_dtype}, "
        f"{n_params} parameters in {time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    b, s = XLSTM_PROMPT
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                              .astype(np.int32)).cuda()
    prefill = steps.make_prefill_step(cfg)
    prefill(params, {"inputs": prompt})                      # warm-up
    torch.cuda.synchronize()
    K.slstm_scan.launches = 0
    with StepRecorder() as rec:
        t0 = time.time()
        last, cache = prefill(params, {"inputs": prompt})
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = {"prefill": K.slstm_scan.launches}
    if counts["prefill"] != groups or rec.steps != [s] * groups:
        raise AssertionError(f"prefill: {counts['prefill']} launches over "
                             f"{rec.steps} steps, want {groups} x {s}")
    if last.shape != (b, cfg.vocab) or not torch.isfinite(last.float()).all() \
            or cache["pos"].tolist() != [s] * b:
        raise AssertionError("prefill: logits or cache malformed")
    times = []
    for _ in range(3):
        t0 = time.time()
        prefill(params, {"inputs": prompt})
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    log(f"  prefill {b} x {s}: {wall * 1e3:.2f} ms (then "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms), slstm_scan "
        f"launches {counts['prefill']} = {groups} groups x 1, each S = {s}")
    del cache, last

    srv = DecodeServer(cfg, params, options=ServeOptions(
        batch=SERVE["batch"], max_len=SERVE["max_len"],
        use_mcma_dispatch=True))
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               SERVE["prompt_len"])
                    .astype(np.int32), max_new=SERVE["max_new"])
            for i in range(SERVE["n_requests"])]
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    K.slstm_scan.launches = 0
    t0 = time.time()
    stats = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts["serve"] = K.slstm_scan.launches
    if not all(r.done and not r.aborted for r in reqs):
        raise AssertionError("xlstm: server did not drain")
    if counts["serve"] != groups * stats["ticks"]:
        raise AssertionError(f"xlstm serve: {counts['serve']} launches, "
                             f"want {groups} x {stats['ticks']}")
    if stats["kv_bytes_resident"] != 0 or stats["invocation_rate"] != 0.0:
        raise AssertionError(f"xlstm serve stats: {stats.asdict()}")
    n_tok = sum(len(r.out) for r in reqs)
    log(f"  serve xlstm: {stats['ticks']} decode ticks, {n_tok} tokens, "
        f"{wall * 1e3 / stats['ticks']:.2f} ms/tick, {n_tok / wall:.1f} "
        f"tokens/s, slstm_scan launches {counts['serve']} = {groups} x "
        f"{stats['ticks']}, kv_bytes_resident 0, invocation rate 0")
    del srv

    # the consistency witness in float32: chunkwise mLSTM over 256 and the
    # kernel at S = 256, against chunkwise over 128 + the recurrent mLSTM
    # update and the kernel at S = 128 then S = 1
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    params.float()
    wb, ws, at = WITNESS["batch"], WITNESS["seq"], WITNESS["at"]
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (wb, ws))
                         .astype(np.int32)).cuda()
    with torch.no_grad():
        full, _, _, _ = M.forward(cfg32, params, x)
    want = full[:, at].float()
    _, cache = steps.make_prefill_step(cfg32)(params, {"inputs": x[:, :at]})
    got, cache = steps.make_decode_step(cfg32)(params, cache,
                                               x[:, at:at + 1])
    torch.cuda.synchronize()
    gap = (got - want).abs().max().item()
    log(f"  float32 witness: forward({ws}) at {at} vs prefill({at}) + "
        f"decode(1): max |diff| {gap:.4g} (logits span "
        f"{want.min().item():.3g}..{want.max().item():.3g})")
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3,
                               msg="xlstm float32 witness")
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError("xlstm float32 witness: greedy tokens differ")
    if cache["pos"].tolist() != [at + 1] * wb:
        raise AssertionError(f"xlstm witness pos {cache['pos'].tolist()}")
    return counts


def smoke_reference_xlstm(np, torch):
    """The float32 xlstm smoke config on the card against the same
    parameters on the CPU (the kernels' PyTorch versions): prefill 32
    tokens, then 8 greedy decode ticks; logits within 1e-4, tokens equal."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    cfg = smoke_config(get_config("xlstm-1.3b"))
    params = M.init_model(0, cfg, device="cuda")
    cpu_params = copy.deepcopy(params).cpu()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 32)).astype(np.int32))
    runs = {}
    for dev, p in (("cpu", cpu_params), ("cuda", params)):
        lg, cache = steps.make_prefill_step(cfg)(p, {"inputs": toks.to(dev)})
        step = steps.make_decode_step(cfg)
        out = [lg.float().cpu()]
        for _ in range(8):
            nxt = lg.argmax(-1).to(torch.int32)[:, None]
            lg, cache = step(p, cache, nxt)
            out.append(lg.float().cpu())
        runs[dev] = torch.stack(out)
    torch.testing.assert_close(runs["cuda"], runs["cpu"], rtol=1e-4,
                               atol=1e-4, msg="xlstm smoke cuda vs cpu")
    if not torch.equal(runs["cuda"].argmax(-1), runs["cpu"].argmax(-1)):
        raise AssertionError("xlstm smoke: greedy tokens differ")
    log(f"  xlstm smoke config f32, prefill 32 + 8 ticks: card within "
        f"{(runs['cuda'] - runs['cpu']).abs().max().item():.3g} of the "
        "CPU, greedy tokens equal")


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

    log("[kernel resources]")
    kernel_resources(torch)

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
    mlp = mlp_kernel_phase(np, torch, flush)
    slstm = slstm_kernel_phase(np, torch, flush)
    del flush

    log("[serve full width]")
    cfg, params, results, (srv, reqs) = serve_full_width(np, torch)
    oracle_witness(torch, cfg, params, srv, reqs)
    del srv, params
    torch.cuda.empty_cache()

    log("[smoke reference]")
    smoke_reference_check(np, torch)
    torch.cuda.empty_cache()

    log("[serve xlstm full width]")
    slstm_launches = serve_xlstm(np, torch)
    torch.cuda.empty_cache()

    log("[smoke reference xlstm]")
    smoke_reference_xlstm(np, torch)

    # library_ms is null for all four: no single PyTorch call computes a
    # per-tile weight-switched MLP, the one-approximator MLP (addmm + tanh
    # + addmm) or the recurrence (a loop of steps)
    rows = []
    for name, src, replaces, tm, launches in (
            ("switched_mlp", "switched_mlp.cu",
             "src/repro/kernels/switched_mlp.py:37",
             timing["switched_mlp", "bfloat16"],
             results["pallas"]["launches"]),
            ("switched_mlp_fused", "fused_dispatch.cu",
             "src/repro/kernels/fused_dispatch.py:120",
             timing["switched_mlp_fused", "bfloat16"],
             results["pallas_fused"]["launches"]),
            ("mlp_forward", "mcma_mlp.cu",
             "src/repro/kernels/mcma_mlp.py:37", mlp["bfloat16"],
             mlp["launches"]),
            ("slstm_scan", "slstm_scan.cu",
             "src/repro/kernels/slstm_scan.py:94",
             slstm["prefill", "bfloat16"], sum(slstm_launches.values()))):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches,
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
