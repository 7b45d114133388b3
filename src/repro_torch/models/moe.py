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
and the aux loss is the data shards' mean.  In the backward a model
rank's combine sees only its own experts' pairs, while the router's
logits and the aux loss are the same on every model rank: the gate
values and the tokens bound for the expert buffer pass through
``collectives.copy_to_model`` (their partial gradients summed over
"model"), the router's gather over "model" takes its slice, and the aux
term reaches the router and x once.  On one device
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
from repro_torch.sharding.activations import manual_dp_context


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


def moe_fwd(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss).  On a mesh whose "model" axis
    divides the experts: expert parallelism (``_moe_fwd_manual``), x the
    rank's rows; elsewhere on a mesh the reference falls back to
    compiler-placed tensor parallelism inside each expert, which the port
    refuses (``model.check_mesh_servable`` / ``check_mesh_trainable``
    name it first).  Without a mesh: token groups of ``moe.scan_chunk``
    (``_moe_chunked``)."""
    mesh, dp = manual_dp_context()
    if mesh is not None:
        md = mesh.size("model") if "model" in mesh.axis_names else 0
        if not md or cfg.moe.n_experts % md:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.moe.n_experts} experts over a model axis "
                f"of {md}: the reference falls back to compiler-placed "
                "tensor parallelism inside each expert there, the port "
                "refuses (ROADMAP queue 3, layout departures)")
        return _moe_fwd_manual(cfg, p, x, mesh, dp, md)
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
    y_part, aux = _moe_local_experts(cfg, router, w, x, e_loc, e_off)
    y = C.all_reduce_sum(y_part, "model", mesh)
    return y, C.all_reduce_sum(aux, dp, mesh) / mesh.size(dp)


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
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    xt = x.reshape(t, d)
    r = route(cfg, router, xt, n_local=e_loc, offset=e_off)
    gate_vals, xs = r.gate_vals, xt
    if e_loc < e:
        gate_vals, xs = C.copy_to_model(gate_vals), C.copy_to_model(xt)
    order = r.order.long()
    tok = order // k                       # the token of each sorted pair
    xe = D.scatter_rows(xs[tok], r.slot, r.keep, e_loc * r.cap) \
        .reshape(e_loc, r.cap, d)
    h = torch.bmm(xe, w["w_in"].to(x.dtype))
    if cfg.gated_ffn:
        h = F.silu(torch.bmm(xe, w["w_gate"].to(x.dtype))) * h
    else:
        h = F.silu(h)
    ye = torch.bmm(h, w["w_out"].to(x.dtype))
    contrib = D.gather_rows(ye.reshape(e_loc * r.cap, d), r.slot, r.keep) \
        * gate_vals.reshape(t * k)[order][:, None].to(ye.dtype)
    # each token's k pairs, in ascending expert id (the stable sort's
    # order), summed from zeros in that fixed order
    parts = contrib[torch.argsort(tok, stable=True)].reshape(t, k, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + parts[:, j]
    frac_tokens = F.one_hot(r.gate_idx[:, 0].long(), e).float().mean(0)
    frac_probs = r.probs.mean(0)
    aux = e * (frac_tokens * frac_probs).sum() * cfg.moe.aux_weight
    return out.reshape(b, s, d), aux


def dropped_choices(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """(dropped, total) (token, expert) choices of one MoE application on
    x (B, S, d) as its forward routes them, over the whole batch: on a
    mesh each data shard routes its own rows at its own capacity (the
    router gathered whole) and both counts are summed over the data
    axes, the same on every rank; without a mesh ``moe.scan_chunk``'s
    groups each route at theirs.  int64 tensors."""
    mesh, dp = manual_dp_context()
    b, s, d = x.shape
    t, ck = b * s, cfg.moe.scan_chunk
    with torch.no_grad():
        if mesh is None:
            router = p.router
            groups = x.reshape(t // ck, ck, d) \
                if ck and t > ck and t % ck == 0 else x.reshape(1, t, d)
        else:
            router = C.gather_whole(p.router, p.router._pspec, mesh)
            groups = x.reshape(1, t, d)
        dropped = sum(int((~route(cfg, router, g).keep).sum())
                      for g in groups)
        out = torch.tensor([dropped, groups.shape[0] * groups.shape[1]
                            * cfg.moe.top_k], dtype=torch.int64,
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
