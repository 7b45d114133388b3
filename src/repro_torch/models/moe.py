"""Mixture-of-Experts FFN with top-k routing, capacity and sort-based
dispatch (counterpart of ``repro/models/moe.py``, single device).

  1. the router's top-k experts per token, the gate values renormalized;
  2. the (token, choice) pairs sorted by expert, each with its rank in
     its expert (``runtime/dispatch.class_sort_ranks``);
  3. the pairs scattered into an (E * cap, d) buffer, pairs ranked past
     an expert's capacity dropped to the trash slot (the GShard
     convention: the residual carries a dropped token);
  4. the experts as batched (E, cap, d) x (E, d, f) products;
  5. the outputs gathered back and combined with the gate values.

Plain PyTorch, as the reference's is plain XLA: no TPU kernel stands
behind it.  The combine is deterministic: where the reference adds each
pair's contribution into its token's row (``.at[tok].add``), the port
takes each token's k contributions in ascending expert id, the order in
which the reference's stable sort visits them, and sums them from zeros
in that order, so no atomic adds reorder the sum from call to call.
The aux load-balancing loss is Switch/GShard's, E * sum_e(f_e * p_e).

On a mesh (inside ``runtime/steps.serve_mesh_context`` or
``train_mesh_context``) with "model" an axis that divides the E experts,
``moe_fwd`` takes the reference's expert-parallel branch,
``_moe_fwd_manual``: each model rank owns E / |model| experts (stored
FSDP over the data axes and gathered at use), routes its data shard's
tokens globally (the router gathered whole) and computes only its own
experts' pairs (``_moe_local_experts``); the partial outputs are summed
over "model" in rank order, so every rank holds the same bits.  Capacity
is per (data shard, expert), the scan_chunk groups do not apply there,
and the aux loss is the data shards' mean.  Where the experts do not
divide over "model" and each expert's d_ff does, ``moe_fwd`` takes
TP-in-expert (``_moe_fwd_tp``), which the reference leaves to the
compiler on its ``_moe_chunked`` path: every model rank holds d_ff /
|model| of every expert and routes as one device routes the global
batch (``route_global``: ``scan_chunk`` groups of the global tokens,
which may span data ranks, each at its own capacity), so its drops are
one device's; the partial outputs are summed over "model".  In the
backward a model rank's combine sees only its own experts' pairs (or
its d_ff slice of them), while the router's logits and the aux loss are
the same on every model rank: the gate values and the tokens bound for
the expert buffer pass through ``collectives.copy_to_model`` (their
partial gradients summed over "model"), the router's gather over
"model" takes its slice, and the aux term reaches the router and x
once.  A served batch below the data axes is whole on every data rank
(``activations.whole_rows``): both branches then route it as one device
(``route_global`` over no data axis), count its drops once, and take no
mean over the data ranks.  A training microbatch below the data axes
(``activations.sequence_split``: each data rank a slice of every row's
positions) routes as one device over the global token groups on both
branches too (``route_global`` with the slices' layout), its aux loss the
global groups'.  On one device
``_moe_local_experts`` over all E experts is ``_moe_group``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import param
from repro_torch.runtime import dispatch as D
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import (manual_dp_context, row_axes,
                                             sequence_shard)


class MoE(nn.Module):
    """The router ``(d, E)`` and the experts' ``w_in`` ``(E, d, f)``,
    ``w_gate`` ``(E, d, f)`` (gated FFNs) and ``w_out`` ``(E, f, d)``,
    scaled by fan-in as the reference's ``init_moe``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        s_in, s_out = d ** -0.5, f ** -0.5
        self.router = param((d, e), cfg.pdtype, device, gen, s_in)
        self.w_in = param((e, d, f), cfg.pdtype, device, gen, s_in)
        self.w_out = param((e, f, d), cfg.pdtype, device, gen, s_out)
        if cfg.gated_ffn:
            self.w_gate = param((e, d, f), cfg.pdtype, device, gen, s_in)


class Routing(NamedTuple):
    """One token group's routing: ``probs`` (T, E) f32, ``gate_vals``
    (T, k) renormalized, ``gate_idx`` (T, k) int32 in descending
    probability (the lower expert id first on a tie, as
    ``jax.lax.top_k``), and over the T * k pairs sorted by expert:
    ``order`` (int32 flat pair ids), ``keep`` and ``slot`` (int32, trash
    slot E * cap); ``cap`` the per-expert capacity."""

    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor, *,
          n_local: int | None = None, offset: int = 0) -> Routing:
    """Router logits in ``xt``'s dtype (the reference's source rounds
    them so; compiled, XLA folds that rounding into an f32 product, which
    in bf16 can flip a near-tied choice), the softmax in f32, the top-k by
    a stable descending sort, then the sort-based ranks and capacity
    slots of the shared dispatch engine.  xt: (T, d).  The capacity is
    computed in Python floats as the reference computes it, over every
    row of the group: padded chunk rows and idle decode slots compete
    for slots as real ones do.  ``n_local`` / ``offset``: only the pairs
    of experts [offset, offset + n_local) are kept (an expert-parallel
    rank's buffer of ``n_local * cap`` slots), with the capacity of the
    global E (default: all E experts)."""
    t = xt.shape[0]
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = min(int(cfg.moe.capacity_factor * t * k / e) + 1, t)
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k].to(torch.int32)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    order, e_sorted, rank, _ = D.class_sort_ranks(gate_idx.reshape(t * k), e)
    keep, slot = D.capacity_slots(e_sorted, rank, cap,
                                  n_local=e if n_local is None else n_local,
                                  offset=offset)
    return Routing(probs, gate_vals, gate_idx, order, keep, slot, cap)


def tp_in_expert(cfg: ModelConfig, md: int) -> bool:
    """True where an MoE's experts do not divide over a model axis of
    ``md``: ``sharding/rules._param_rule`` then splits every expert's
    d_ff over "model" (which ``model.check_mesh_servable`` requires to
    divide), TP-in-expert (``_moe_fwd_tp``)."""
    return bool(cfg.moe.n_experts) and cfg.moe.n_experts % md != 0


def moe_fwd(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss).  On a mesh whose "model" axis
    divides the experts: expert parallelism (``_moe_fwd_manual``), x the
    rank's rows; where it does not and each expert's d_ff divides:
    TP-in-expert (``_moe_fwd_tp``), routed as the reference's compiler-
    placed ``_moe_chunked`` routes, over the global tokens; elsewhere on
    a mesh the port refuses (``model.check_mesh_servable`` /
    ``check_mesh_trainable`` name it first).  Without a mesh: token
    groups of ``moe.scan_chunk`` (``_moe_chunked``)."""
    mesh, dp = manual_dp_context()[0], row_axes()
    if mesh is not None:
        md = mesh.size("model") if "model" in mesh.axis_names else 0
        if md and not tp_in_expert(cfg, md):
            return _moe_fwd_manual(cfg, p, x, mesh, dp, md)
        if md and cfg.d_ff % md == 0:
            return _moe_fwd_tp(cfg, p, x, mesh, dp)
        raise NotImplementedError(
            f"{cfg.name}: {cfg.moe.n_experts} experts of d_ff {cfg.d_ff} "
            f"over a model axis of {md}: neither the experts nor each "
            "expert's d_ff divide; the reference falls back to compiler-"
            "placed sharding there, the port refuses (ROADMAP queue 3, "
            "layout departures)")
    return _moe_chunked(cfg, p, x)


def _moe_fwd_manual(cfg: ModelConfig, p: MoE, x: torch.Tensor, mesh, dp,
                    md: int):
    """Expert parallelism, one rank's part: this model rank owns experts
    [e_off, e_off + E / |model|), x (B_local, S, d) is its data shard's
    tokens, replicated over "model".  The router (d, E) and the expert
    stacks are gathered over the data axes in ONE collective
    (``collectives.unshard``, whose backward reduce-scatters), the
    router's columns then over "model" (a replicated consumer: the
    backward takes its slice); the rank's experts run on its pairs and
    the partial outputs are summed over "model".  Capacity is per (data
    shard, expert), over the rank's tokens (idle and padded rows
    included) with the global E; the aux loss is averaged over the data
    shards, the same on every rank."""
    e = cfg.moe.n_experts
    names = ("w_in", "w_out") + (("w_gate",) if cfg.gated_ffn else ())
    router, *stacks = C.unshard(p.router, *(getattr(p, n) for n in names),
                                mesh=mesh)
    if router.shape[1] != e:
        router = C.all_gather(router, "model", 1, mesh)
    w = dict(zip(names, stacks))
    e_loc = e // md
    e_off = mesh.index("model") * e_loc
    assert w["w_in"].shape[0] == e_loc, (w["w_in"].shape, e_loc)
    shard = sequence_shard(x.shape[1])
    if dp and shard is None:
        y_part, aux = _moe_local_experts(cfg, router, w, x, e_loc, e_off)
        aux = C.all_reduce_sum(aux, dp, mesh) / mesh.size(dp)
    else:
        y_part, aux = _moe_routed_globally(cfg, router, w, x, e_loc, e_off,
                                           mesh, dp, shard)
    return C.all_reduce_sum(y_part, "model", mesh), aux


def _moe_routed_globally(cfg: ModelConfig, router: torch.Tensor, w: dict,
                         x: torch.Tensor, e_loc: int, e_off: int, mesh, dp,
                         shard):
    """Expert parallelism where every data rank holds every row: a served
    batch below the data axes (``activations.whole_rows``, ``dp`` empty)
    or a training microbatch there, each data rank its slice of the
    positions (``shard``, ``activations.sequence_split``).  The tokens
    are routed as one device routes them (``route_global``: the global
    ``scan_chunk`` groups, each at its own capacity), then only the pairs
    of experts [e_off, e_off + e_loc) kept in this rank's buffer.  The
    reference's expert-parallel ``shard_map`` has no such case (ROADMAP,
    layout departures).  Returns (partial output, aux)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    r = route_global(cfg, router, xt, mesh, dp, shard, b)
    lo, n_slots = (e_off * r.n_groups * r.cap_l,
                   e_loc * r.n_groups * r.cap_l)
    mine = r.keep & (r.slot >= lo) & (r.slot < lo + n_slots)
    slot = torch.where(mine, r.slot - lo, n_slots).to(torch.int32)
    out = _experts(cfg, w, C.copy_to_model(xt),
                   C.copy_to_model(r.gate_vals), r.order, slot, mine,
                   n_slots)
    return out.reshape(b, s, d), r.aux


def _moe_local_experts(cfg: ModelConfig, router: torch.Tensor, w: dict,
                       x: torch.Tensor, e_loc: int, e_off: int):
    """Route the tokens x (B, S, d) to experts [e_off, e_off + e_loc) of
    the E (global top-k routing, local compute): ``router`` (d, E) whole,
    ``w`` the e_loc experts' stacks.  Returns the partial output (zeros
    for the pairs whose experts live elsewhere) and the aux loss over
    these tokens.  Each token's pairs are summed from zeros in ascending
    expert id, no atomics.  With fewer than E experts (a model rank of a
    mesh) the gate values and the tokens bound for the buffer pass
    through ``copy_to_model``: their gradients here are partial."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    xt = x.reshape(b * s, d)
    r = route(cfg, router, xt, n_local=e_loc, offset=e_off)
    gate_vals, xs = r.gate_vals, xt
    if e_loc < e:
        gate_vals, xs = C.copy_to_model(gate_vals), C.copy_to_model(xt)
    out = _experts(cfg, w, xs, gate_vals, r.order, r.slot, r.keep,
                   e_loc * r.cap)
    frac_tokens = F.one_hot(r.gate_idx[:, 0].long(), e).float().mean(0)
    frac_probs = r.probs.mean(0)
    aux = e * (frac_tokens * frac_probs).sum() * cfg.moe.aux_weight
    return out.reshape(b, s, d), aux


def _experts(cfg: ModelConfig, w: dict, xs: torch.Tensor,
             gate_vals: torch.Tensor, order: torch.Tensor,
             slot: torch.Tensor, keep: torch.Tensor, n_slots: int):
    """The routed pairs through the experts: the tokens xs (T, d) of the
    pairs in ``order`` scattered into an (n_slots, d) buffer at ``slot``
    (``keep``), viewed as one run of rows an expert of ``w``'s stacks,
    the batched expert FFN, the rows gathered back and weighted by the
    gate values (T, k).  Each token's k pairs, in ascending expert id
    (the stable sort's order), are summed from zeros in that fixed
    order, no atomics.  Returns (T, d)."""
    t, d = xs.shape
    k = cfg.moe.top_k
    order = order.long()
    tok = order // k                       # the token of each sorted pair
    xe = D.scatter_rows(xs[tok], slot, keep, n_slots) \
        .reshape(w["w_in"].shape[0], -1, d)
    h = torch.bmm(xe, w["w_in"].to(xs.dtype))
    if cfg.gated_ffn:
        h = F.silu(torch.bmm(xe, w["w_gate"].to(xs.dtype))) * h
    else:
        h = F.silu(h)
    ye = torch.bmm(h, w["w_out"].to(xs.dtype))
    contrib = D.gather_rows(ye.reshape(n_slots, d), slot, keep) \
        * gate_vals.reshape(t * k)[order][:, None].to(ye.dtype)
    parts = contrib[torch.argsort(tok, stable=True)].reshape(t, k, d)
    out = torch.zeros((t, d), dtype=xs.dtype, device=xs.device)
    for j in range(k):
        out = out + parts[:, j]
    return out


class GlobalRouting(NamedTuple):
    """One data rank's part of the routing of ``_moe_chunked`` over the
    GLOBAL tokens (groups of ``moe.scan_chunk`` of the global B * S, each
    at its own capacity ``cap``): ``route``'s fields for the rank's
    tokens, the pairs sorted by (the rank's group, expert), ``keep`` by
    each pair's rank among its group's pairs of its expert (the earlier
    data ranks' pairs counted), and ``slot`` into an (E, n_groups * cap_l)
    buffer of the rank's own pairs; ``aux`` the groups' mean of the
    load-balancing loss, the same on every rank."""

    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    n_groups: int
    cap_l: int
    aux: torch.Tensor


def route_global(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor,
                 mesh, dp, shard=None, rows: int = 1) -> GlobalRouting:
    """Route the data rank's tokens xt (T_local, d) as one device routes
    the global batch (``_moe_chunked``): the rank's tokens are tokens
    [i T_local, (i + 1) T_local) of the global B * S (data rank i), or
    under a sequence split (``shard``, an ``activations.SeqShard``) the
    rank's slice of the positions of each of its ``rows`` rows; the
    global tokens split into groups of ``scan_chunk`` where that splits
    them evenly, else one group.  A group may span data ranks (decode's
    one group of B tokens; training's groups of a few rows; a row's
    slices): each rank's pair counts per (run of its tokens, group,
    expert) are gathered over the data axes (one int32 all-gather, with
    the top-1 counts of the aux loss), so a pair's rank counts every
    pair of its group and expert that comes earlier in the global order,
    and the drops are one device's.  The aux loss's probability means
    are all-reduced over the data axes (whose backward passes each rank
    its tokens' part)."""
    t, d = xt.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n_dp, i = mesh.size(dp), mesh.index(dp)
    t_all, ck = t * n_dp, cfg.moe.scan_chunk
    g_size = ck if ck and t_all > ck and t_all % ck == 0 else t_all
    n_groups = t_all // g_size
    cap = min(int(cfg.moe.capacity_factor * g_size * k / e) + 1, g_size)
    cap_l = min(cap, t)         # a rank's pairs of one (group, expert)
    # each rank's tokens as runs of ``run`` consecutive global tokens
    if shard is None:
        run, starts = t, [[j * t] for j in range(n_dp)]
    else:
        run = t // rows
        starts = [[r * shard.total + j * run for r in range(rows)]
                  for j in range(n_dp)]
    # the pieces where this rank's runs meet the groups: (run, local
    # tokens, group), in the global order
    pieces = []
    for u, st in enumerate(starts[i]):
        a = st
        while a < st + run:
            grp = a // g_size
            z = min((grp + 1) * g_size, st + run)
            pieces.append((u, slice(u * run + a - st, u * run + z - st),
                           grp))
            a = z
    groups = sorted({grp for _, _, grp in pieces})
    n_lg = len(groups)
    lg_of = {grp: j for j, grp in enumerate(groups)}
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k].to(torch.int32)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    dev = xt.device

    def per_token(values):
        """A (T_local,) int64 tensor holding each piece's value on its
        tokens (filled on the device: no copy from the host)."""
        return torch.cat([torch.full((sl.stop - sl.start,), v,
                                     dtype=torch.int64, device=dev)
                          for v, (_, sl, _) in zip(values, pieces)])
    piece = per_token(range(len(pieces)))
    cls = (piece[:, None] * e + gate_idx).reshape(t * k)
    order, cls_sorted, rank, counts = D.class_sort_ranks(
        cls, len(pieces) * e)
    counts = counts.view(len(pieces), e)
    # this rank's pair counts and top-1 counts per (run, group, expert),
    # and its probabilities' sums per group; a piece's tokens are a
    # contiguous run, summed in order (no atomics: the same bits on every
    # model rank)
    n_runs = len(starts[i])
    mine = torch.zeros((2, n_runs, n_groups, e), dtype=torch.int32,
                       device=dev)
    top1 = F.one_hot(gate_idx[:, 0].long(), e).to(torch.int32)
    part = {}
    for j, (u, sl, grp) in enumerate(pieces):
        mine[0, u, grp] = counts[j]
        mine[1, u, grp] = top1[sl].sum(0)
        ps = probs[sl].sum(0)
        part[grp] = ps if grp not in part else part[grp] + ps
    every = C.all_gather(mine[None], dp, 0, mesh)  # (n_dp, 2, R, G, E)
    # the pairs of earlier runs (every rank's, in the global order) per
    # (group, expert), and of this rank's own earlier runs
    glob = sorted((st, j, u) for j in range(n_dp)
                  for u, st in enumerate(starts[j]))
    seq = torch.stack([every[j, 0, u] for _, j, u in glob])
    before = torch.cumsum(seq, 0, dtype=torch.int32) - seq
    at = {(j, u): m for m, (_, j, u) in enumerate(glob)}
    own = torch.cumsum(mine[0], 0, dtype=torch.int32) - mine[0]
    tok, e_s = order.long() // k, (cls_sorted % e).long()
    run_of, grp_of, lg_s, glob_run = (per_token(v)[tok] for v in (
        [u for u, _, _ in pieces], [grp for _, _, grp in pieces],
        [lg_of[grp] for _, _, grp in pieces],
        [at[i, u] for u, _, _ in pieces]))
    keep = rank + before[glob_run, grp_of, e_s] < cap
    local = rank + own[run_of, grp_of, e_s]
    trash = e * n_lg * cap_l
    slot = torch.where(keep, (e_s * n_lg + lg_s) * cap_l + local,
                       trash).to(torch.int32)
    blocks, nxt = [], 0
    for grp in groups:
        if grp > nxt:
            blocks.append(probs.new_zeros((grp - nxt, e)))
        blocks.append(part[grp][None])
        nxt = grp + 1
    if nxt < n_groups:
        blocks.append(probs.new_zeros((n_groups - nxt, e)))
    frac_probs = C.all_reduce_sum(torch.cat(blocks), dp, mesh) / g_size
    frac_tokens = every[:, 1].sum((0, 1)).float() / g_size
    aux = (e * (frac_tokens * frac_probs).sum(-1)
           * cfg.moe.aux_weight).mean()
    return GlobalRouting(gate_vals, gate_idx, order, keep, slot, n_lg,
                         cap_l, aux)


def _moe_fwd_tp(cfg: ModelConfig, p: MoE, x: torch.Tensor, mesh, dp):
    """TP-in-expert, one rank's part (the experts do not divide over
    "model", each expert's d_ff does): the rank holds every expert's d_ff
    / |model| columns of ``w_in`` / ``w_gate`` and rows of ``w_out``,
    stored FSDP over data (gathered with the router in ONE ``unshard``),
    and x (B_local, S, d), its data shard's tokens, replicated over
    "model".  Routing is the reference's ``_moe_chunked`` over the global
    tokens (``route_global``), the same on every model rank; the rank's
    pairs run through its d_ff slice of every expert and the partial
    outputs are summed over "model" in rank order (``_experts``, the
    expert-parallel path's combine).  The gate values and the tokens
    bound for the buffer pass through ``copy_to_model`` (a model rank's
    product over its d_ff slice gives them partial gradients); the
    router's logits and the aux loss are whole on every model rank."""
    b, s, d = x.shape
    names = ("w_in", "w_out") + (("w_gate",) if cfg.gated_ffn else ())
    router, *stacks = C.unshard(p.router, *(getattr(p, n) for n in names),
                                mesh=mesh)
    xt = x.reshape(b * s, d)
    r = route_global(cfg, router, xt, mesh, dp, sequence_shard(s), b)
    out = _experts(cfg, dict(zip(names, stacks)), C.copy_to_model(xt),
                   C.copy_to_model(r.gate_vals), r.order, r.slot, r.keep,
                   cfg.moe.n_experts * r.n_groups * r.cap_l)
    return C.all_reduce_sum(out.reshape(b, s, d), "model", mesh), r.aux


def dropped_choices(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """(dropped, total) (token, expert) choices of one MoE application on
    x (B, S, d) as its forward routes them, over the whole batch: on an
    expert-parallel mesh each data shard routes its own rows at its own
    capacity (the router gathered whole), under TP-in-expert the global
    groups route (``route_global``), and both counts are summed over the
    data axes, the same on every rank; without a mesh, or on one whose
    data ranks each hold every row (``activations.whole_rows``), counted
    once as ``moe.scan_chunk``'s groups each route at theirs.  int64
    tensors."""
    mesh, dp = manual_dp_context()[0], row_axes()
    b, s, d = x.shape
    t, ck = b * s, cfg.moe.scan_chunk
    with torch.no_grad():
        if mesh is None:
            groups = x.reshape(t // ck, ck, d) \
                if ck and t > ck and t % ck == 0 else x.reshape(1, t, d)
            dropped = sum(int((~route(cfg, p.router, g).keep).sum())
                          for g in groups)
        else:
            router = C.gather_whole(p.router, p.router._pspec, mesh)
            xt = x.reshape(t, d)
            shard = sequence_shard(s)
            r = route_global(cfg, router, xt, mesh, dp, shard, b) \
                if tp_in_expert(cfg, mesh.size("model")) or not dp \
                or shard is not None else route(cfg, router, xt)
            dropped = int((~r.keep).sum())
        out = torch.tensor([dropped, t * cfg.moe.top_k], dtype=torch.int64,
                           device=x.device)
        if mesh is not None:
            out = C.all_reduce_sum(out, dp, mesh)
    return out[0], out[1]


def _moe_chunked(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Token groups of ``moe.scan_chunk`` when that splits the B * S
    tokens into equal groups (the capacity is per group), else one
    group; the aux loss is the groups' mean.  Under ``cfg.remat`` each
    group is recomputed in the backward (the reference checkpoints each
    group of its scan): fewer activations kept, the same values."""
    b, s, d = x.shape
    t = b * s
    ck = cfg.moe.scan_chunk
    if not (ck and t > ck and t % ck == 0):
        return _moe_group(cfg, p, x)
    ys, auxs = [], []
    for xc in x.reshape(t // ck, 1, ck, d):
        if cfg.remat and torch.is_grad_enabled():
            y, aux = checkpoint(_moe_group, cfg, p, xc, use_reentrant=False)
        else:
            y, aux = _moe_group(cfg, p, xc)
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys).reshape(b, s, d), torch.stack(auxs).mean()


def _moe_group(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """One token group.  x: (B, S, d) -> (out, aux_loss): every expert
    local (``_moe_local_experts`` over all E)."""
    w = {n: getattr(p, n) for n in ("w_in", "w_out", "w_gate")
         if hasattr(p, n)}
    return _moe_local_experts(cfg, p.router, w, x, cfg.moe.n_experts, 0)
