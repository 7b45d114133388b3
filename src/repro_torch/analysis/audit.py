"""Stage 2: the run-time auditor (counterpart of
``repro/analysis/audit.py``).

The linter (stage 1) proves the contracts the AST can see; this stage
proves the ones only running can: it builds the real engine entry points
(``make_dispatch_plan`` / ``execute_dispatch``, ``mcma_dispatch``,
``mcma_dispatch_sharded`` on a mesh, and the decode / prefill-chunk
steps, dense and paged, at layer and tick scope) and drives each across
a capacity ladder, QoS margin settings, residency sets and row masks,
checking the three run-time contracts:

  TA001  one program per entry point per capacity point.  The port runs
         eagerly, so its programs are STEP OBJECTS (jit_cache.py): a
         ``DecodeServer`` holds one per capacity rung it served, however
         the margins, residency, tiers and masks move; and no CUDA
         library is built again once loaded (``kernels/build.py``);
  TA002  every integer leaf of the invoke stats and of the dispatch plans
         is int32: a drift (int64 from torch's argsort, bincount or
         cumsum) breaks the all-reduced stats' exactness and the
         autotuner's accumulators;
  TA003  no host sync inside a step: ``sync_counts`` runs a call under a
         dispatch mode that records the ops that make the host wait for
         a CUDA device whatever device they run on (``SYNC_OPS``, and
         indexing with a boolean mask), and, for CUDA tensors, under
         ``torch.cuda.set_sync_debug_mode("warn")``, whose warnings
         catch what the op list cannot (a copy to the host).  One sync
         in a step is a wait on every layer of every tick.

Findings use the linter's ``Finding`` record with ``audit:<entry>``
paths, so the CLI and the baseline treat both stages alike.  The helpers
(``retrace_findings``, ``stats_dtype_findings``, ``callback_findings``)
serve any callable; the grid (``CAPACITY_LADDER``, ``MARGIN_SETS``,
``RESIDENCY_SETS``, ``engine_case``, ``variants``) is the reference's,
its inputs drawn with numpy from a seed.  ``audit_steps`` is what
chip_smoke.py runs on the card at full width.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import tempfile
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.jit_cache import cache_size, kernel_builds

# aten ops that make the host wait for a CUDA device, whatever device
# they run on here (TA003): a scalar read (.item(), int(t), `if t:`), an
# output sized by the data, a comparison read on the host, host data
# copied into a step (torch.tensor inside it)
SYNC_OPS = frozenset({
    "_local_scalar_dense", "is_nonzero", "equal", "nonzero",
    "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive",
    "repeat_interleave.Tensor", "lift_fresh",
})
# indexing ops that sync when an index is a boolean mask (the mask is
# turned into positions, whose count the host must learn)
MASK_INDEX_OPS = frozenset({"index.Tensor", "index_put", "index_put_",
                            "_index_put_impl_"})


# ---------------------------------------------------------------------------
# reusable checks
# ---------------------------------------------------------------------------

def retrace_findings(fn, *, scope: str, path: str = "audit:trace",
                     expected: int = 1) -> list[Finding]:
    """TA001 on an already-exercised ``fn``: it must hold exactly
    ``expected`` programs (jit_cache.cache_size: a server's step objects,
    a compiled callable's graphs).  Silent for an eager callable."""
    n = cache_size(fn)
    if n is None or n == expected:
        return []
    return [Finding(
        rule="TA001", path=path, line=0, scope=scope, detail="retrace",
        message=(f"{scope}: {n} programs (step objects) where {expected} "
                 "expected — a traced input (margins / residency / tier / "
                 "row_mask) built a new one; only capacity rungs (shapes) "
                 "may"))]


def build_findings(before: dict, *, scope: str,
                   path: str = "audit:trace") -> list[Finding]:
    """TA001 for the CUDA libraries: no ``nvcc`` since ``before``
    (``jit_cache.kernel_builds()``) and at most one library per source."""
    from repro_torch.kernels import build
    now = kernel_builds()
    findings = []
    if now["compiles"] != before["compiles"]:
        findings.append(Finding(
            rule="TA001", path=path, line=0, scope=scope,
            detail="kernel-rebuild",
            message=(f"{scope}: {now['compiles'] - before['compiles']} nvcc "
                     "run(s) during the audited calls — a kernel must be "
                     "built once, before serving")))
    if not set(now["loaded"]) <= set(build.SOURCES):
        findings.append(Finding(
            rule="TA001", path=path, line=0, scope=scope,
            detail="kernel-libraries",
            message=(f"{scope}: libraries {sorted(now['loaded'])} loaded, "
                     f"not one per source of {build.SOURCES}")))
    return findings


def _int_leaves(obj, prefix=""):
    """(name, tensor) for every tensor leaf of stats / plans / metrics."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif hasattr(obj, "asdict"):
        yield from _int_leaves(obj.asdict(), prefix)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _int_leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _int_leaves(v, f"{prefix}[{k!r}]")


def _is_integer(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def stats_dtype_findings(stats, *, scope: str,
                         path: str = "audit:trace") -> list[Finding]:
    """TA002: every integer-dtype tensor leaf of an invoke-stats record (or
    a plan, or a metrics dict) must be exactly int32.  Float and bool
    leaves are skipped, as the reference skips float leaves."""
    findings = []
    for name, leaf in _int_leaves(stats):
        if _is_integer(leaf.dtype) and leaf.dtype != torch.int32:
            findings.append(Finding(
                rule="TA002", path=path, line=0, scope=scope,
                detail=f"stats-dtype:{name}",
                message=(f"{scope}: stats leaf {name} is {leaf.dtype}, not "
                         "int32 — integer counters must stay int32 end to "
                         "end (all-reduce exactness, autotune "
                         "accumulators)")))
    return findings


def _first_device(obj):
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, torch.nn.Module):
        return next((p.device for p in obj.parameters()), None)
    items = obj.values() if isinstance(obj, dict) else \
        obj if isinstance(obj, (list, tuple)) else ()
    for v in items:
        d = _first_device(v)
        if d is not None:
            return d
    return None


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _recorder(device_type: str):
    """A dispatch mode counting SYNC_OPS (and mask indexing) whose tensor
    lies on ``device_type``: on the card a CPU-side scalar is no sync."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.analysis.opcount import op_names

    class SyncRecorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            packet, full = op_names(func)
            name = packet if packet in SYNC_OPS else \
                full if full in SYNC_OPS else None
            if name is None and full in MASK_INDEX_OPS and len(args) > 1 \
                    and any(t.dtype in (torch.bool, torch.uint8)
                            for t in _tensors(args[1])):
                name = f"{packet}[bool]"
            out = func(*args, **(kwargs or {}))
            if name is not None:
                t = next(_tensors(args), None)
                if t is None or t.device.type == device_type:
                    self.ops[name] += 1
            return out

    return SyncRecorder()


def sync_counts(fn, args, *, kwargs=None):
    """Run ``fn(*args, **kwargs)`` once; returns ``(output, {op: count},
    warnings)``: the host syncs the op list records on the device of the
    first tensor in ``args`` and, for a CUDA device, the waits the sync
    debug mode warned of.  The debug mode is restored on exit."""
    device = _first_device(args) or torch.device("cpu")
    rec = _recorder(device.type)
    cuda = device.type == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prev = torch.cuda.get_sync_debug_mode() if cuda else None
        try:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            with rec:
                out = fn(*args, **(kwargs or {}))
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
    waits = sum("synchroniz" in str(w.message) for w in caught) if cuda \
        else 0
    return out, dict(rec.ops), waits


def _sync_findings(ops: dict, waits: int, *, scope: str,
                   path: str) -> list[Finding]:
    findings = [Finding(
        rule="TA003", path=path, line=0, scope=scope, detail=f"sync:{op}",
        message=(f"{scope}: {n} x {op} in one call — each makes the host "
                 "wait for the device, on every layer of every tick"))
        for op, n in sorted(ops.items())]
    if waits > sum(ops.values()):
        findings.append(Finding(
            rule="TA003", path=path, line=0, scope=scope,
            detail="sync:unlisted",
            message=(f"{scope}: the sync debug mode saw {waits} waits, the "
                     f"op list {sum(ops.values())}: a sync SYNC_OPS does "
                     "not name (add it there)")))
    return findings


def callback_findings(fn, args, *, scope: str, kwargs=None,
                      path: str = "audit:trace") -> list[Finding]:
    """TA003: run ``fn(*args)`` once (``sync_counts``) and report each host
    sync it makes, ``sync:<op>``.  The reference's name: its syncs are
    host callbacks in a jaxpr."""
    _, ops, waits = sync_counts(fn, args, kwargs=kwargs)
    return _sync_findings(ops, waits, scope=scope, path=path)


class PlanCapture:
    """Records every ``make_dispatch_plan`` result within the block,
    through each module binding the serving path calls (the layer-scope
    engine's and the tick plan's), and restores them on exit."""

    def __enter__(self):
        from repro_torch.models import approx_ffn
        from repro_torch.runtime import dispatch
        self.mods, self.real = (approx_ffn, dispatch), \
            dispatch.make_dispatch_plan
        self.plans = []

        def captured(*a, **k):
            plan = self.real(*a, **k)
            self.plans.append(plan)
            return plan
        for m in self.mods:
            m.make_dispatch_plan = captured
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.make_dispatch_plan = self.real


def plan_findings(plans, *, scope: str, path: str) -> list[Finding]:
    """TA002 over captured plans and the stats each gives, one finding
    per leaf name."""
    from repro_torch.runtime.dispatch import plan_invoke_stats
    out = {}
    for plan in plans:
        for f in stats_dtype_findings(plan, scope=scope, path=path) \
                + stats_dtype_findings(plan_invoke_stats(plan), scope=scope,
                                       path=path):
            out.setdefault(f.key, f)
    return list(out.values())


def rungs_visited(summary: dict) -> set:
    """The ladder rungs a decode tick ran on, from a CapacityController
    summary: the start and every switch's target but one made at the last
    observed tick."""
    sw = summary["switches"]
    start = sw[0]["from_index"] if sw else summary["final_index"]
    return {start} | {x["to_index"] for x in sw
                      if x["tick"] < summary["ticks"]}


# ---------------------------------------------------------------------------
# the audited entry points
# ---------------------------------------------------------------------------

# capacity ladder: >= 3 (exact_cap, invoke_cap) points, each its own
# program by design (capacities are shapes)
CAPACITY_LADDER = ((64, 32), (48, 16), (32, 8))
MARGIN_SETS = ([8.0, 0.0, -8.0], [0.0, 0.0, 0.0])      # 2 QoS margin vectors
RESIDENCY_SETS = ([4, 1], [2, 5])                      # 2 hot sets, lib=6
_T, _LIB, _D, _DH = 64, 6, 32, 12
BLOCK_T = 16


def engine_case(seed: int = 0) -> dict:
    """The engine audit's inputs as float32 numpy arrays, from ``seed``:
    rows ``x``, library-wide router ``logits`` (computed here, so both
    packages route the same values), the library's approximator stacks
    (``w1``, ``b1``, ``w2``, ``b2``, not yet prepadded) and the exact
    path's ``wi``, ``wo``."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x = f(_T, _D, sc=0.5)
    return dict(x=x, logits=(x @ f(_D, _LIB + 1, sc=0.5)).astype(np.float32),
                w1=f(_LIB, _D, _DH, sc=0.2), b1=f(_LIB, _DH, sc=0.1),
                w2=f(_LIB, _DH, _D, sc=0.2), b2=f(_LIB, _D, sc=0.1),
                wi=f(_D, 2 * _D, sc=0.1), wo=f(2 * _D, _D, sc=0.1))


def variants() -> list:
    """The traced-input grid every program must absorb, as numpy arrays:
    2 margin vectors x 2 residency sets x 2 row masks, with a mixed
    3-tier vector throughout.  Each is (tier, margins, residency, mask)."""
    tier = np.asarray([i % 3 for i in range(_T)], np.int32)
    masks = (np.ones((_T,), bool),
             np.asarray([True] * (_T - 8) + [False] * 8))
    return [(tier, np.asarray(m, np.float32), np.asarray(r, np.int32), mask)
            for m in MARGIN_SETS for r in RESIDENCY_SETS for mask in masks]


def _torch_case(seed: int):
    from repro_torch.kernels import ops
    c = {k: torch.from_numpy(v) for k, v in engine_case(seed).items()}
    stacks = ops.prepad_switched_weights(c["w1"], c["b1"], c["w2"], c["b2"])
    wi, wo = c["wi"], c["wo"]
    return c["x"], c["logits"], stacks, (wi, wo)


def _torch_variant(v):
    return tuple(torch.from_numpy(a) for a in v)


def _exact(wi, wo):
    return lambda xb: F.silu(xb @ wi) @ wo


def _audit_engine(backend: str) -> list[Finding]:
    """``mcma_dispatch`` per capacity-ladder point: TA001 (no rebuild),
    TA002 (every variant's stats), TA003 (every variant's call)."""
    from repro_torch.runtime import dispatch as D
    x, logits, stacks, (wi, wo) = _torch_case(0)
    exact_fn = _exact(wi, wo)
    findings = {}
    for exact_cap, invoke_cap in CAPACITY_LADDER:
        scope = f"mcma_dispatch[{backend},cap=({exact_cap},{invoke_cap})]"

        def run(xv, lg, tier, margins, residency, mask):
            return D.mcma_dispatch(
                xv, lg, exact_fn, *stacks, exact_cap=exact_cap,
                invoke_cap=invoke_cap, backend=backend, block_t=BLOCK_T,
                weights_prepadded=True, row_mask=mask, tier=tier,
                tier_margins=margins, residency=residency)

        before = kernel_builds()
        fs = []
        for v in variants():
            (_, stats), ops, waits = sync_counts(
                run, (x, logits) + _torch_variant(v))
            fs += stats_dtype_findings(stats, scope=scope,
                                       path="audit:engine")
            fs += _sync_findings(ops, waits, scope=scope, path="audit:engine")
        fs += retrace_findings(run, scope=scope, path="audit:engine")
        fs += build_findings(before, scope=scope, path="audit:engine")
        for f in fs:
            findings.setdefault(f.key, f)
    return list(findings.values())


def _audit_plan_execute(backend: str) -> list[Finding]:
    """The split API: one planning function and one executor absorb every
    traced-input variant at a fixed capacity point; a plan built against
    a residency set executes against the resident-GATHERED stacks, as the
    server does."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import dispatch as D
    x, logits, stacks, (wi, wo) = _torch_case(1)
    exact_fn = _exact(wi, wo)
    exact_cap, invoke_cap = CAPACITY_LADDER[1]
    scope_p = f"make_dispatch_plan[{backend}]"
    scope_e = f"execute_dispatch[{backend}]"

    def plan_fn(lg, tier, margins, residency, mask):
        return D.make_dispatch_plan(
            lg, mask, exact_cap=exact_cap, invoke_cap=invoke_cap,
            backend=backend, block_t=BLOCK_T, tier=tier,
            tier_margins=margins, residency=residency)

    def exec_fn(plan, xv, residency):
        return D.execute_dispatch(
            plan, xv, exact_fn, *ops.gather_resident_stacks(*stacks,
                                                            residency),
            weights_prepadded=True)

    before = kernel_builds()
    fs = []
    for v in variants():
        tier, margins, residency, mask = _torch_variant(v)
        plan, p_ops, p_waits = sync_counts(
            plan_fn, (logits, tier, margins, residency, mask))
        _, e_ops, e_waits = sync_counts(exec_fn, (plan, x, residency))
        fs += plan_findings([plan], scope=scope_p, path="audit:engine")
        fs += _sync_findings(p_ops, p_waits, scope=scope_p,
                             path="audit:engine")
        fs += _sync_findings(e_ops, e_waits, scope=scope_e,
                             path="audit:engine")
    fs += retrace_findings(plan_fn, scope=scope_p, path="audit:engine")
    fs += retrace_findings(exec_fn, scope=scope_e, path="audit:engine")
    fs += build_findings(before, scope=scope_e, path="audit:engine")
    return list({f.key: f for f in fs}.values())


def audit_sharded(mesh, backends=("xla", "pallas", "pallas_fused")
                  ) -> list[Finding]:
    """``mcma_dispatch_sharded`` on ``mesh`` (run by every rank of an
    initialized world, launch/mesh.spawn_world): the sharded wrapper keeps
    the int32 stats and adds no host sync, at the ladder's first point;
    and the served steps at a batch below the data axes
    (``audit_whole_rows``)."""
    from repro_torch.runtime import dispatch as D
    x, logits, stacks, (wi, wo) = _torch_case(2)
    exact_cap, invoke_cap = CAPACITY_LADDER[0]
    fs = []
    for backend in backends:
        scope = f"mcma_dispatch_sharded[{backend}]"

        def run(xv, lg, tier, margins, residency, mask):
            return D.mcma_dispatch_sharded(
                mesh, xv, lg, lambda p, xb: F.silu(xb @ p[0]) @ p[1],
                (wi, wo), *stacks, exact_cap=exact_cap,
                invoke_cap=invoke_cap, backend=backend, block_t=BLOCK_T,
                weights_prepadded=True, row_mask=mask, tier=tier,
                tier_margins=margins, residency=residency)

        before = kernel_builds()
        for v in variants():
            (_, stats), ops, waits = sync_counts(
                run, (x, logits) + _torch_variant(v))
            fs += stats_dtype_findings(stats, scope=scope,
                                       path="audit:engine")
            fs += _sync_findings(ops, waits, scope=scope, path="audit:engine")
        fs += retrace_findings(run, scope=scope, path="audit:engine")
        fs += build_findings(before, scope=scope, path="audit:engine")
        fs += audit_whole_rows(mesh, backend)
    return sorted({f.key: f for f in fs}.values(), key=lambda f: f.key)


def audit_whole_rows(mesh, backend: str, batch: int = 1,
                     max_len: int = 32) -> list[Finding]:
    """The served steps at a batch below ``mesh``'s data axes (every data
    rank holding every row, ``activations.whole_rows``): the smoke serve
    config's decode and prefill-chunk steps at tick scope over a dense
    cache split by sequence over the data axes (context-parallel), and
    the decode step over a paged pool (whole on every data rank), keep
    the int32 stats and add no host sync (TA002, TA003)."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as steps_lib
    cfg = smoke_serve_cfg(backend)
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, route_scope="tick"))
    params = M.init_model(0, cfg, device="cpu", mesh=mesh)
    toks, ctoks, n_valid, tier, masks, margins, residencies = step_inputs(
        batch, "cpu")
    kw = dict(use_mcma_dispatch=True, with_stats=True, backend=backend)
    decode = steps_lib.make_decode_step(cfg, **kw)
    chunk = steps_lib.make_prefill_chunk_step(cfg, **kw)
    scope = f"whole_rows[{backend}]"
    assert max_len % 8 == 0, max_len
    fs = []
    with steps_lib.serve_mesh_context(mesh):
        for step, head, page in ((decode, (toks,), 0),
                                 (chunk, (ctoks, n_valid), 0),
                                 (decode, (toks,), 8)):
            cache = M.init_cache(cfg, batch, max_len, page_size=page,
                                 kv_pages=batch * max_len // 8 if page
                                 else 0, device="cpu")
            if page:
                cache["block_table"].copy_(torch.arange(
                    cache["block_table"].shape[1], dtype=torch.int32)[None])
            out, ops, waits = sync_counts(
                step, (params, cache, *head, masks[0], tier, margins[0],
                       residencies[0]))
            fs += stats_dtype_findings(out[-1], scope=scope,
                                       path="audit:steps")
            fs += _sync_findings(ops, waits, scope=scope,
                                 path="audit:steps")
    return fs


def _sharded_rank(rank: int, out_dir: str, backends: tuple):
    """One rank of ``run_audit``'s sharded world: a (2,) data mesh."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    fs = audit_sharded(make_host_mesh(data=2), backends)
    if rank == 0:
        Path(out_dir, "findings.json").write_text(json.dumps(
            [dataclasses.asdict(f) for f in fs]))


def _spawn_sharded(backends) -> list[Finding]:
    """``audit_sharded`` in a 2-rank gloo world of its own processes (an
    initialized process group must not outlive the audit)."""
    from repro_torch.launch.mesh import spawn_world
    with tempfile.TemporaryDirectory() as tmp:
        spawn_world(_sharded_rank, 2, (tmp, tuple(backends)),
                    init_method=f"file://{tmp}/rendezvous", exchange_mib=1)
        return [Finding(**d) for d in
                json.loads(Path(tmp, "findings.json").read_text())]


def smoke_serve_cfg(backend: str = "xla"):
    """The audited model: internlm2-1.8b's smoke config with MCMA and a
    library of 6 approximators (2 resident slots)."""
    from repro_torch.configs.registry import get_config, smoke_config
    base = smoke_config(get_config("internlm2-1.8b"))
    return dataclasses.replace(base, approx=dataclasses.replace(
        base.approx, enable=True, library_size=6,
        backend=backend, block_t=BLOCK_T))


def step_inputs(b: int, device, residency_sets=RESIDENCY_SETS):
    """A step's token inputs at batch ``b``: ``(toks (b, 1), chunk tokens
    (b, 4), n_valid, tier, masks, margins, residencies)``."""
    dev = torch.device(device)
    toks = torch.arange(1, b + 1, dtype=torch.int32, device=dev)[:, None]
    ctoks = toks.repeat(1, 4)
    n_valid = torch.tensor([(4, 2, 4, 0)[i % 4] for i in range(b)],
                           dtype=torch.int32, device=dev)
    tier = torch.tensor([(0, 1, 2, 1)[i % 4] for i in range(b)],
                        dtype=torch.int32, device=dev)
    masks = (torch.ones((b,), dtype=torch.bool, device=dev),
             torch.tensor([True] * (b - 1) + [False], device=dev))
    margins = [torch.tensor(m, dtype=torch.float32, device=dev)
               for m in MARGIN_SETS]
    residencies = [torch.tensor(r, dtype=torch.int32, device=dev)
                   for r in residency_sets]
    return toks, ctoks, n_valid, tier, masks, margins, residencies


def _block_tables(b: int, n_pp: int, device):
    """Two allocator states: in-order pages, and a scrambled free list with
    half of each row unallocated (-1)."""
    n_pages = b * n_pp
    ident = torch.arange(n_pages, dtype=torch.int32).reshape(b, n_pp)
    perm = torch.tensor([(7 * k + 3) % n_pages for k in range(n_pages)],
                        dtype=torch.int32).reshape(b, n_pp)
    if n_pp > 1:
        perm[:, n_pp // 2:] = -1
    return ident.to(device), perm.to(device)


def _launches() -> int:
    from repro_torch.kernels import fused_dispatch, switched_mlp
    return switched_mlp.switched_mlp.launches \
        + fused_dispatch.switched_mlp_fused.launches


def audit_steps(cfg, params, backend: str, *, batch: int = 4,
                max_len: int = 32, page_sizes=(8, 16),
                scopes=("layer", "tick"), residency_sets=RESIDENCY_SETS,
                device="cpu"):
    """The served entry points on ``params``: for each route scope, one
    decode step and one prefill-chunk step absorb the grid (2 margin
    vectors x 2 residency sets x 2 row masks) on a dense cache, and for
    each page size both absorb 2 block tables x 2 row masks on a paged
    one.  Every call runs under ``sync_counts`` and ``PlanCapture``.

    Returns ``(findings, calls)``: TA001 (no kernel rebuild; an eager step
    is its own single program), TA002 over every captured plan and its
    stats and the steps' integer metrics, TA003 over every call; and one
    record per call: ``{"step", "scope", "layout", "syncs" ({op: n}),
    "waits", "launches", "plans"}`` (``launches``: switch-kernel
    launches, on a CUDA device; ``plans``: dispatch plans checked)."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as steps_lib
    dev = torch.device(device)
    toks, ctoks, n_valid, tier, masks, margins, residencies = step_inputs(
        batch, dev, residency_sets)
    findings, calls = {}, []
    before = kernel_builds()

    def call(step, args, name, scope, layout, tag):
        n0 = _launches()
        with PlanCapture() as cap:
            out, ops, waits = sync_counts(step, args)
        calls.append(dict(step=name, scope=scope, layout=layout, syncs=ops,
                          waits=waits, launches=_launches() - n0,
                          plans=len(cap.plans)))
        metrics = out[-1]
        fs = plan_findings(cap.plans, scope=f"{name}{tag}",
                           path="audit:steps")
        fs += stats_dtype_findings(metrics, scope=f"{name}{tag}",
                                   path="audit:steps")
        fs += _sync_findings(ops, waits, scope=f"{name}{tag}",
                             path="audit:steps")
        fs += retrace_findings(step, scope=f"{name}{tag}",
                               path="audit:steps")
        for f in fs:
            findings.setdefault(f.key, f)

    for scope in scopes:
        c = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, route_scope=scope, backend=backend))
        kw = dict(use_mcma_dispatch=True, with_stats=True, backend=backend)
        decode = steps_lib.make_decode_step(c, **kw)
        chunk = steps_lib.make_prefill_chunk_step(c, **kw)
        tag = f"[{backend},{scope}]"
        for m in margins:
            for r in residencies:
                for mask in masks:
                    call(decode, (params, M.init_cache(c, batch, max_len,
                                                       device=dev),
                                  toks, mask, tier, m, r),
                         "decode_step", scope, "dense", tag)
                    call(chunk, (params, M.init_cache(c, batch, max_len,
                                                      device=dev),
                                 ctoks, n_valid, mask, tier, m, r),
                         "prefill_chunk_step", scope, "dense", tag)
        for page_size in page_sizes:
            assert max_len % page_size == 0, (max_len, page_size)
            n_pp = max_len // page_size
            tag_p = f"[{backend},{scope},P={page_size}]"
            for bt in _block_tables(batch, n_pp, dev):
                for mask in masks:
                    for step, name, head in (
                            (decode, "paged_decode_step", (toks,)),
                            (chunk, "paged_prefill_chunk_step",
                             (ctoks, n_valid))):
                        cache = M.init_cache(c, batch, max_len,
                                             page_size=page_size,
                                             kv_pages=batch * n_pp,
                                             device=dev)
                        cache["block_table"] = bt.clone()
                        call(step, (params, cache, *head, mask, tier,
                                    margins[0], residencies[0]),
                             name, scope, f"paged{page_size}", tag_p)
    for f in build_findings(before, scope=f"steps[{backend}]",
                            path="audit:steps"):
        findings.setdefault(f.key, f)
    return list(findings.values()), calls


# the server stream of the TA001 audit: autotune over the default ladder
# at tick scope, QoS tiers and a library of 6 (2 resident)
SERVER_PROMPTS = (3, 9, 17, 5, 12, 25)
SERVER_OPTIONS = dict(batch=4, max_len=64, use_mcma_dispatch=True,
                      route_scope="tick", prefill_chunk=8, kv_page_size=8,
                      autotune=True, drop_budget=0.05, qos_tiers=True,
                      autotune_kwargs=dict(cooldown=1, down_patience=2))


def audit_server(server, *, scope: str) -> list[Finding]:
    """TA001 on a drained autotuning ``DecodeServer``: it built one step
    object per rung its decode ticks visited, however its tiers,
    residency and masks moved."""
    visited = rungs_visited(server.controller.summary())
    return retrace_findings(server, scope=scope, path="audit:steps",
                            expected=len(visited))


def _audit_server(backend: str, params) -> list[Finding]:
    from repro_torch.runtime.options import LibrarySpec, ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = smoke_serve_cfg(backend)
    srv = DecodeServer(cfg, params, options=ServeOptions(
        **SERVER_OPTIONS, backend=backend,
        library=LibrarySpec(6, 2, observe_window=2, cooldown=2)))
    rng = np.random.default_rng(1)
    for i, n in enumerate(SERVER_PROMPTS):
        srv.submit(Request(rid=i, prompt=rng.integers(1, cfg.vocab, n)
                           .astype(np.int32), max_new=6, tier=i % 3))
    srv.run_until_drained(max_ticks=400)
    return audit_server(srv, scope=f"DecodeServer[{backend},autotune]")


def run_audit(*, backends=("xla", "pallas", "pallas_fused"),
              with_steps: bool = True, sharded: bool = True
              ) -> list[Finding]:
    """Audit every engine entry point; [] = every contract holds.

    The sweep covers all three executors (the eager oracle, the switched
    kernel and the fused kernel; on the CPU the kernels' PyTorch twins).
    ``with_steps=False`` skips the model steps and the server stream;
    ``sharded=False`` skips ``mcma_dispatch_sharded``, which otherwise
    runs in a 2-rank world of its own (pytest audits it inside the
    sharded-dispatch test's world instead).  Changes no global state that
    outlives it."""
    findings: list[Finding] = []
    params = None
    if with_steps:
        from repro_torch.models import model as M
        params = M.init_model(0, smoke_serve_cfg(), device="cpu")
    for be in backends:
        findings += _audit_engine(be)
        findings += _audit_plan_execute(be)
        if with_steps:
            findings += audit_steps(smoke_serve_cfg(be), params, be)[0]
    if with_steps and backends:
        findings += _audit_server(
            "pallas" if "pallas" in backends else backends[0], params)
    if sharded and backends:
        findings += _spawn_sharded(backends)
    findings.sort(key=lambda f: (f.path, f.scope, f.rule, f.detail))
    return findings
