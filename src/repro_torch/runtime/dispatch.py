"""MCMA dispatch runtime — the serving-side invocation engine
(counterpart of ``repro/runtime/dispatch.py``, single device).

  classify   router/classifier logits -> per-row class (0 = exact / nC)
  capacity   static per-class token budgets (over-capacity rows contribute
             zero; the residual carries them)
  class-sort rows grouped into single-class row-tiles
             (kernels/ops.class_sort_plan)
  switch     the weight-switch kernel runs each tile under its class's
             approximator weights (kernels/switched_mlp.py)
  exact      class-0 rows run the exact function on a gathered capacity
             buffer; in the kernel paths the nC/over-capacity rows ride
             through the kernel under a zero-weight pseudo-approximator
  scatter    results return to the original row order

Backends (``backend=``): "pallas" runs the switched CUDA kernel,
"pallas_fused" the fused CUDA kernel (gather/scatter folded in, bitwise
equal to "pallas"), and "xla" the eager per-class loop, the oracle both
kernels are held to.  Every plan and stat tensor is int32, as in the
reference, and building a plan never waits for the device.

On a mesh (one process per rank, ``launch/mesh.HostMesh``) each data
shard classifies, capacities, class-sorts and weight-switches its OWN
rows, with no dispatch traffic between shards; with ``stats_axes`` the
count fields are all-reduced over those axes
(``sharding/collectives.all_reduce_sum``, one collective a plan), so
every rank reports the GLOBAL totals.  ``mcma_dispatch_sharded`` runs the
engine that way on a global row batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import ops
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import activation_sharding
from repro_torch.sharding.rules import P, dp_axes, shard_capacity

PALLAS_BACKENDS = ("pallas", "pallas_fused")
DISPATCH_BACKENDS = ("xla",) + PALLAS_BACKENDS

_I32 = torch.int32


def _ints(values, device) -> torch.Tensor:
    """A small int32 vector of Python ints, filled on ``device`` one
    element at a time (``fill_`` takes the value as a kernel argument;
    a copy from host memory, or item assignment, waits for the device)."""
    out = torch.empty(len(values), dtype=_I32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def route(logits: torch.Tensor, tier: torch.Tensor | None = None,
          tier_margins: torch.Tensor | None = None) -> torch.Tensor:
    """Router/classifier logits (T, n+1) -> class ids (T,) int32; 0 = exact.

    ``tier`` ((T,) int32) indexes ``tier_margins`` ((n_tiers,) float32), a
    per-tier bias added to the EXACT-path logit before the argmax."""
    lg = logits.float()
    if tier is not None and tier_margins is not None:
        lg = lg.clone()
        lg[:, 0] += tier_margins.float()[tier.long()]
    return torch.argmax(lg, -1).to(_I32)


def apply_approximator(xb, w1, b1, w2, b2):
    """One approximator's tanh MLP on a row block, in ``xb``'s dtype."""
    h = torch.tanh(xb @ w1.to(xb.dtype) + b1.to(xb.dtype))
    return h @ w2.to(xb.dtype) + b2.to(xb.dtype)


def _rank_in_class(cls: torch.Tensor, n_classes: int) -> torch.Tensor:
    """rank[i] = #rows j<=i with cls[j]==cls[i], minus one (arrival order)."""
    oh = (cls[:, None] == torch.arange(n_classes, device=cls.device)) \
        .to(_I32)
    ranks = torch.cumsum(oh, 0, dtype=_I32) - 1
    return torch.gather(ranks, 1, cls.long()[:, None])[:, 0]


def class_sort_ranks(cls: torch.Tensor, n: int):
    """Stable class-sort with within-class arrival ranks: ``(order,
    cls_sorted, rank, counts)``."""
    order = torch.argsort(cls, stable=True).to(_I32)
    cls_sorted = cls[order.long()]
    counts = ops.bincount(cls, n)
    zero = torch.zeros(1, dtype=_I32, device=cls.device)
    starts = torch.cat([zero, torch.cumsum(counts, 0, dtype=_I32)])
    rank = torch.arange(cls.shape[0], dtype=_I32, device=cls.device) \
        - starts[cls_sorted.long()]
    return order, cls_sorted, rank, counts


def capacity_slots(cls_sorted, rank, cap: int, *, n_local: int, offset=0):
    """keep mask + buffer slots for a (n_local, cap) capacity buffer; rows
    outside [offset, offset + n_local) or ranked past ``cap`` fall into
    the trash slot ``n_local * cap``."""
    local = (cls_sorted >= offset) & (cls_sorted < offset + n_local)
    keep = (rank < cap) & local
    slot = torch.where(keep, (cls_sorted - offset) * cap + rank,
                       n_local * cap).to(_I32)
    return keep, slot


def scatter_rows(rows: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                 n_slots: int) -> torch.Tensor:
    """rows (R, d) -> (n_slots, d) buffer; slot n_slots is the trash row.

    A slot outside [0, n_slots] is dropped to the trash row, never wrapped
    onto a real slot; duplicate slots sum (``index_add_``), so the
    engine's unique valid slots are written exactly."""
    slot = slot.to(_I32)
    ok = keep & (slot >= 0) & (slot <= n_slots)
    buf = rows.new_zeros((n_slots + 1, rows.shape[-1]))
    buf.index_add_(0, torch.where(ok, slot, n_slots).long(),
                   rows * ok[:, None])
    return buf[:n_slots]


def gather_rows(y: torch.Tensor, slot: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """(n_slots, d_out) buffer -> per-row outputs; dropped rows and slots
    outside [0, n_slots) read an appended zero row."""
    n_slots = y.shape[0]
    y = torch.cat([y, y.new_zeros((1, y.shape[-1]))], 0)
    slot = slot.to(_I32)
    ok = keep & (slot >= 0) & (slot < n_slots)
    return y[torch.where(ok, slot, n_slots).long()] * ok[:, None]


def capacity_path(x: torch.Tensor, mask: torch.Tensor, cap: int,
                  fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Gather <=cap rows where mask, apply fn, scatter back (zeros elsewhere)."""
    pos = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    keep = mask & (pos < cap)
    slot = torch.where(keep, pos, cap)
    y = fn(scatter_rows(x, slot, keep, cap))
    return gather_rows(y, slot, keep)


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """One routing decision over a flat row batch, ready to execute.

    Tensor fields (int32 unless noted): cls, rank, eff (kernel class ids:
    kept approx rows ``cls - 1``, everything else the pseudo-class
    ``n_approx``), order/pos (class-sort of ``eff``; identity placeholders
    on "xla" plans), tile_cls, exact_keep (bool), exact_slot, counts,
    dispatched, t_total, executed, tier, tier_counts, tier_dispatched,
    lib_counts, off_set_rows.  Static fields: n_approx, exact_cap,
    invoke_cap (int, or a per-class tuple), block_t, backend, n_tiers,
    library_size.  Field meanings are those of the reference's
    ``DispatchPlan``.
    """

    cls: torch.Tensor
    rank: torch.Tensor
    eff: torch.Tensor
    order: torch.Tensor
    pos: torch.Tensor
    tile_cls: torch.Tensor
    exact_keep: torch.Tensor
    exact_slot: torch.Tensor
    counts: torch.Tensor
    dispatched: torch.Tensor
    t_total: torch.Tensor
    executed: torch.Tensor
    tier: torch.Tensor
    tier_counts: torch.Tensor
    tier_dispatched: torch.Tensor
    lib_counts: torch.Tensor
    off_set_rows: torch.Tensor
    n_approx: int
    exact_cap: int
    invoke_cap: int | tuple
    block_t: int
    backend: str
    n_tiers: int
    library_size: int

    @property
    def class_caps(self) -> tuple:
        """Per-class invoke capacities, length ``n_approx``."""
        ic = self.invoke_cap
        return tuple(ic) if isinstance(ic, (tuple, list)) \
            else (ic,) * self.n_approx


def make_dispatch_plan(logits: torch.Tensor,
                       row_mask: torch.Tensor | None = None, *,
                       exact_cap: int | None = None, invoke_cap=None,
                       operating_point=None, backend: str = "xla",
                       block_t: int = 128,
                       stats_axes: tuple = (),
                       tier: torch.Tensor | None = None,
                       tier_margins: torch.Tensor | None = None,
                       n_tiers: int | None = None,
                       residency: torch.Tensor | None = None) -> DispatchPlan:
    """classify -> capacity -> class-sort, once, as a reusable plan.

    logits: (T, n_approx + 1) router scores (class 0 = exact); ``row_mask``
    marks ACTIVE rows.  Capacities come from ``exact_cap``/``invoke_cap``
    (an int shared by every class or a length-n_approx tuple) or from an
    ``operating_point`` (runtime/autotune.OperatingPoint, applied to this
    batch's row count through sharding/rules.shard_capacity with its
    slack; its ``invoke_fracs`` give the per-class form).
    ``tier``/``tier_margins`` apply per-row QoS margins and split the
    counts per tier; ``residency`` ((n_resident,) library ids) folds
    full-library routing onto resident slots.  ``stats_axes`` (mesh axis
    names, inside a mesh context): the count fields (``t_total``,
    ``counts``, ``dispatched``, ``executed``, the tier matrices and, with
    a residency, ``lib_counts`` and ``off_set_rows``) are all-reduced to
    global totals, in one collective; the row fields stay shard-local.
    """
    if backend not in DISPATCH_BACKENDS:
        raise ValueError(f"unknown dispatch backend: {backend!r}")
    t = logits.shape[0]
    dev = logits.device
    if residency is not None:
        library_size = logits.shape[-1] - 1
        n = int(residency.shape[0])
        assert n <= library_size, (n, library_size)
    else:
        library_size = 0
        n = logits.shape[-1] - 1
    if operating_point is not None:
        assert exact_cap is None and invoke_cap is None, \
            "pass capacities OR an operating_point, not both"
        pt = operating_point
        exact_cap = shard_capacity(t, pt.exact_frac, slack=pt.shard_slack)
        if pt.invoke_fracs:
            invoke_cap = tuple(shard_capacity(t, f, slack=pt.shard_slack)
                               for f in pt.class_fracs(n))
        else:
            invoke_cap = shard_capacity(t, pt.invoke_frac,
                                        slack=pt.shard_slack)
    if isinstance(invoke_cap, list):
        invoke_cap = tuple(invoke_cap)
    class_caps = tuple(invoke_cap) if isinstance(invoke_cap, tuple) \
        else (int(invoke_cap),) * n
    assert len(class_caps) == n, (
        f"per-class invoke_cap tuple (len {len(class_caps)}) must carry "
        f"one budget per approximator (n_approx={n})")
    assert tier is None or tier_margins is not None or n_tiers is not None, \
        "tiered dispatch needs the (n_tiers,) tier_margins vector (or an " \
        "explicit n_tiers) alongside the tier ids"
    nt = int(tier_margins.shape[0]) if tier_margins is not None \
        else int(n_tiers or 1)
    tier_ids = torch.zeros((t,), dtype=_I32, device=dev) if tier is None \
        else tier.to(_I32)

    cls = route(logits, None if tier is None else tier_ids, tier_margins)
    lib_cls = cls
    if residency is not None:
        slot_map = torch.zeros((library_size + 1,), dtype=_I32, device=dev)
        slot_map[residency.long() + 1] = torch.arange(1, n + 1, dtype=_I32,
                                                      device=dev)
        cls = slot_map[lib_cls.long()]
    if row_mask is not None:
        mask = row_mask.to(torch.bool)
        cls = torch.where(mask, cls, 0).to(_I32)
        routed_col = torch.where(mask, cls, n + 1)
        counts = ops.bincount(routed_col, n + 2)[:n + 1]
        exact_mask = (cls == 0) & mask
        t_total = mask.to(_I32).sum(dtype=_I32)
    else:
        routed_col = cls
        counts = ops.bincount(cls, n + 1)
        exact_mask = cls == 0
        t_total = torch.full((), t, dtype=_I32, device=dev)
    tier_counts = ops.bincount(tier_ids * (n + 2) + routed_col,
                               nt * (n + 2)).reshape(nt, n + 2)[:, :n + 1]

    if residency is not None:
        off_mask = (lib_cls > 0) & (cls == 0)
        if row_mask is not None:
            lib_col = torch.where(mask, lib_cls, library_size + 1)
            off_mask = off_mask & mask
        else:
            lib_col = lib_cls
        lib_counts = ops.bincount(lib_col,
                                  library_size + 2)[:library_size + 1]
        off_set_rows = off_mask.to(_I32).sum(dtype=_I32)
    else:
        lib_counts = counts
        off_set_rows = torch.zeros((), dtype=_I32, device=dev)

    rank = _rank_in_class(cls, n + 1)
    cap_of = _ints((0,) + class_caps, dev)
    kept = (cls > 0) & (rank < cap_of[cls.long()])
    eff = torch.where(kept, cls - 1, n).to(_I32)
    if backend in PALLAS_BACKENDS:
        order, pos, tile_cls, _, _ = ops.class_sort_plan(eff, n + 1, block_t)
    else:
        n_tiles = ops.worst_case_rows(t, n + 1, block_t) // block_t
        order = pos = torch.arange(t, dtype=_I32, device=dev)
        tile_cls = torch.zeros((n_tiles,), dtype=_I32, device=dev)

    epos = torch.cumsum(exact_mask.to(_I32), 0, dtype=_I32) - 1
    exact_keep = exact_mask & (epos < exact_cap)
    exact_slot = torch.where(exact_keep, epos, exact_cap).to(_I32)

    caps = _ints((exact_cap,) + class_caps, dev)
    dispatched = torch.minimum(counts, caps)
    disp_col = torch.where(exact_keep | kept, cls, n + 1)
    tier_dispatched = ops.bincount(tier_ids * (n + 2) + disp_col,
                                nt * (n + 2)).reshape(nt, n + 2)[:, :n + 1]
    if backend in PALLAS_BACKENDS:
        executed = exact_cap + ops.worst_case_rows(t, n + 1, block_t)
    else:
        executed = exact_cap + sum(class_caps)
    executed = torch.full((), executed, dtype=_I32, device=dev)
    if stats_axes:
        counts, dispatched, t_total, executed, tier_counts, \
            tier_dispatched, lib_counts, off_set_rows = _all_reduce_stats(
                tuple(stats_axes), counts, dispatched, t_total, executed,
                tier_counts, tier_dispatched, lib_counts, off_set_rows,
                residency is not None)
    return DispatchPlan(cls=cls, rank=rank, eff=eff, order=order, pos=pos,
                        tile_cls=tile_cls, exact_keep=exact_keep,
                        exact_slot=exact_slot, counts=counts,
                        dispatched=dispatched, t_total=t_total,
                        executed=executed, tier=tier_ids,
                        tier_counts=tier_counts,
                        tier_dispatched=tier_dispatched,
                        lib_counts=lib_counts, off_set_rows=off_set_rows,
                        n_approx=n, exact_cap=exact_cap,
                        invoke_cap=invoke_cap, block_t=block_t,
                        backend=backend, n_tiers=nt,
                        library_size=library_size)


def _all_reduce_stats(axes, counts, dispatched, t_total, executed,
                      tier_counts, tier_dispatched, lib_counts, off_set_rows,
                      library: bool):
    """A plan's count fields summed over ``axes``: packed into one int32
    vector, one all-reduce, unpacked.  Each is a sum of per-shard terms,
    so the totals equal the per-shard runs' summed exactly.  Without a
    residency ``lib_counts`` stays aliased to the reduced ``counts``."""
    parts = [counts, dispatched, t_total, executed, tier_counts,
             tier_dispatched] + ([lib_counts, off_set_rows] if library else [])
    flat = C.all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]), axes)
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].view(p.shape))
        off += p.numel()
    if not library:
        out += [out[0], off_set_rows]
    return out


@dataclasses.dataclass(frozen=True)
class InvokeStats:
    """The engine's per-call invocation statistics (tensors), with the
    reference's field names and dict-style access:

      class_counts, dispatched   (n_approx + 1,) int32 routed / executed
      dropped                    int32 over-capacity rows
      exact_frac, invocation     float32 (invocation = 1 - exact_frac,
                                 0.0 on a fully idle batch)
      executed_rows, padding_rows  int32
      tier_counts, tier_dispatched (n_tiers, n_approx + 1) int32
      tier_dropped               (n_tiers,) int32
      tier_served_invocation     (n_tiers,) float32
      lib_counts                 (library_size + 1,) int32
      off_set_exact_rows         int32
    """

    class_counts: torch.Tensor
    dispatched: torch.Tensor
    dropped: torch.Tensor
    exact_frac: torch.Tensor
    invocation: torch.Tensor
    executed_rows: torch.Tensor
    padding_rows: torch.Tensor
    tier_counts: torch.Tensor
    tier_dispatched: torch.Tensor
    tier_dropped: torch.Tensor
    tier_served_invocation: torch.Tensor
    lib_counts: torch.Tensor
    off_set_exact_rows: torch.Tensor

    def __getitem__(self, key: str):
        if key not in _STATS_FIELDS:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in _STATS_FIELDS

    def __iter__(self):
        return iter(_STATS_FIELDS)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def keys(self):
        return iter(_STATS_FIELDS)

    def items(self):
        return ((f, getattr(self, f)) for f in _STATS_FIELDS)

    def asdict(self) -> dict:
        return {f: getattr(self, f) for f in _STATS_FIELDS}


_STATS_FIELDS = tuple(f.name for f in dataclasses.fields(InvokeStats))


def plan_invoke_stats(plan: DispatchPlan) -> InvokeStats:
    """The engine's ``InvokeStats``, derived from a plan."""
    exact_frac = (plan.counts[0] / plan.t_total.clamp(min=1)).float()
    invocation = torch.where(plan.t_total > 0, 1.0 - exact_frac,
                             0.0).float()
    tier_rows = plan.tier_counts.sum(-1, dtype=_I32)
    return InvokeStats(
        class_counts=plan.counts,
        dispatched=plan.dispatched,
        dropped=(plan.counts - plan.dispatched).sum(dtype=_I32),
        exact_frac=exact_frac,
        invocation=invocation,
        executed_rows=plan.executed,
        padding_rows=plan.executed - plan.dispatched.sum(dtype=_I32),
        tier_counts=plan.tier_counts,
        tier_dispatched=plan.tier_dispatched,
        tier_dropped=(plan.tier_counts - plan.tier_dispatched)
        .sum(-1, dtype=_I32),
        tier_served_invocation=(
            plan.tier_dispatched[:, 1:].sum(-1, dtype=_I32)
            / tier_rows.clamp(min=1)).float(),
        lib_counts=plan.lib_counts,
        off_set_exact_rows=plan.off_set_rows)


def execute_dispatch(plan: DispatchPlan, x: torch.Tensor,
                     exact_fn: Callable[[torch.Tensor], torch.Tensor],
                     a_w1, a_b1, a_w2, a_b2, *,
                     weights_prepadded: bool = False) -> torch.Tensor:
    """Apply one layer's approximators + exact path against a plan.

    x: (T, d) rows in ORIGINAL order; returns (T, d_out) in original
    order.  ``plan.backend`` picks the executor."""
    n = plan.n_approx
    assert a_w1.shape[0] - (1 if weights_prepadded else 0) == n, (
        f"approximator stack (leading dim {a_w1.shape[0]}, "
        f"weights_prepadded={weights_prepadded}) does not match the plan's "
        f"n_approx={n}")
    xg = scatter_rows(x, plan.exact_slot, plan.exact_keep, plan.exact_cap)
    out = gather_rows(exact_fn(xg), plan.exact_slot, plan.exact_keep)

    if plan.backend == "xla":
        d_out, d_in = out.shape[-1], x.shape[1]
        for i, cap_i in enumerate(plan.class_caps):
            if weights_prepadded:
                w = (a_w1[i, :d_in], a_b1[i], a_w2[i][:, :d_out],
                     a_b2[i, :d_out])
            else:
                w = (a_w1[i], a_b1[i], a_w2[i], a_b2[i])
            keep = (plan.cls == i + 1) & (plan.rank < cap_i)
            slot = torch.where(keep, plan.rank, cap_i)
            xb = scatter_rows(x, slot, keep, cap_i)
            out = out + gather_rows(apply_approximator(xb, *w), slot, keep)
        return out
    # kernel backends: one grouped launch over ALL rows on the plan's
    # class-sort; exact / over-capacity / inactive rows ride the
    # zero-weight pseudo-class n and come out exactly zero
    apply = ops.switched_apply if plan.backend == "pallas" \
        else ops.switched_apply_fused
    sort_plan = (plan.order, plan.pos, plan.tile_cls)
    if weights_prepadded:
        return out + apply(x, plan.eff, a_w1, a_b1, a_w2, a_b2,
                           block_t=plan.block_t, prepadded=True,
                           d_out=out.shape[-1], sort_plan=sort_plan)

    def zcls(w):
        return torch.cat([w, torch.zeros_like(w[:1])], 0)
    return out + apply(x, plan.eff, zcls(a_w1), zcls(a_b1), zcls(a_w2),
                       zcls(a_b2), block_t=plan.block_t,
                       sort_plan=sort_plan)


def mcma_dispatch(x: torch.Tensor, logits: torch.Tensor,
                  exact_fn: Callable[[torch.Tensor], torch.Tensor],
                  a_w1, a_b1, a_w2, a_b2, *, exact_cap: int, invoke_cap,
                  backend: str = "xla", block_t: int = 128,
                  stats_axes: tuple = (),
                  row_mask: torch.Tensor | None = None,
                  weights_prepadded: bool = False,
                  tier: torch.Tensor | None = None,
                  tier_margins: torch.Tensor | None = None,
                  residency: torch.Tensor | None = None):
    """Full MCMA invocation pipeline over a flat row batch:
    ``make_dispatch_plan`` + ``execute_dispatch`` + ``plan_invoke_stats``.
    ``stats_axes``: on a mesh, the axes the stats are all-reduced over
    (the compute stays this shard's own).

    x: (T, d); logits: (T, n_approx+1) router scores (class 0 = exact);
    exact_fn: (cap, d) -> (cap, d_out) on the gathered class-0 buffer;
    a_*: stacked approximator weights, leading dim n_approx (or serving
    form with ``weights_prepadded``).  ``row_mask`` marks ACTIVE rows;
    ``residency`` selects resident rows of a prepadded LIBRARY stack.
    Returns ``(y, InvokeStats)`` with y (T, d_out) in the original order.
    """
    if residency is not None:
        assert weights_prepadded, (
            "library residency requires prepadded stacks "
            "(ops.prepad_switched_weights over the full library)")
        assert logits.shape[-1] == a_w1.shape[0], (logits.shape, a_w1.shape)
        a_w1, a_b1, a_w2, a_b2 = ops.gather_resident_stacks(
            a_w1, a_b1, a_w2, a_b2, residency)
    n = a_w1.shape[0] - (1 if weights_prepadded else 0)
    assert residency is not None or logits.shape[-1] == n + 1, (
        f"router width {logits.shape[-1]} != n_approx + 1 = {n + 1}")
    plan = make_dispatch_plan(logits, row_mask, exact_cap=exact_cap,
                              invoke_cap=invoke_cap, backend=backend,
                              block_t=block_t, stats_axes=stats_axes,
                              tier=tier, tier_margins=tier_margins,
                              residency=residency)
    out = execute_dispatch(plan, x, exact_fn, a_w1, a_b1, a_w2, a_b2,
                           weights_prepadded=weights_prepadded)
    return out, plan_invoke_stats(plan)


def mcma_dispatch_sharded(mesh, x: torch.Tensor, logits: torch.Tensor,
                          exact_fn: Callable, exact_params,
                          a_w1, a_b1, a_w2, a_b2, *, exact_cap: int,
                          invoke_cap, backend: str = "xla",
                          block_t: int = 128, data_axes=None,
                          row_mask: torch.Tensor | None = None,
                          weights_prepadded: bool = False,
                          tier: torch.Tensor | None = None,
                          tier_margins: torch.Tensor | None = None,
                          residency: torch.Tensor | None = None):
    """``mcma_dispatch`` over a mesh's data axes, run by every rank of
    ``mesh`` on the same GLOBAL inputs.

    Each rank takes its data shard's rows of ``x``, ``logits``,
    ``row_mask`` and ``tier`` (as ``sharding/rules.mcma_dispatch_specs``
    places them) and runs the engine on them alone; the exact params,
    the stacks, the margins and the residency vector are replicated.
    ``exact_cap``/``invoke_cap`` are PER-SHARD capacities (from a global
    operating point through ``sharding/rules.shard_capacity``), so a
    class hot on one shard drops rows another shard could have taken:
    the reference's semantics.  ``exact_fn(exact_params, xb)``.

    Returns ``(y, invoke_stats)``: y (T, d_out), the shards' outputs
    all-gathered back into the global row order, and the stats
    all-reduced to the global totals, the same on every rank.
    """
    dp = tuple(data_axes) if data_axes is not None else dp_axes(mesh)
    rows = C.local_rows(mesh, dp, x.shape[0])
    local = lambda t: None if t is None else t[rows]
    with activation_sharding(P(dp, None), mesh):
        y, stats = mcma_dispatch(
            x[rows], logits[rows], lambda xb: exact_fn(exact_params, xb),
            a_w1, a_b1, a_w2, a_b2, exact_cap=exact_cap,
            invoke_cap=invoke_cap, backend=backend, block_t=block_t,
            stats_axes=dp, row_mask=local(row_mask),
            weights_prepadded=weights_prepadded, tier=local(tier),
            tier_margins=tier_margins, residency=residency)
        return C.all_gather(y, dp, 0), stats
