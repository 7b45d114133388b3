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

The mesh branch (``_moe_fwd_manual``, ``_moe_local_experts``) comes with
the MoE family's mesh (ROADMAP queue 1, item 15); on one device
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


def route(cfg: ModelConfig, router: torch.Tensor,
          xt: torch.Tensor) -> Routing:
    """Router logits in ``xt``'s dtype (the reference's source rounds
    them so; compiled, XLA folds that rounding into an f32 product, which
    in bf16 can flip a near-tied choice), the softmax in f32, the top-k by
    a stable descending sort, then the sort-based ranks and capacity
    slots of the shared dispatch engine.  xt: (T, d).  The capacity is
    computed in Python floats as the reference computes it, over every
    row of the group: padded chunk rows and idle decode slots compete
    for slots as real ones do."""
    t = xt.shape[0]
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = min(int(cfg.moe.capacity_factor * t * k / e) + 1, t)
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k].to(torch.int32)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    order, e_sorted, rank, _ = D.class_sort_ranks(gate_idx.reshape(t * k), e)
    keep, slot = D.capacity_slots(e_sorted, rank, cap, n_local=e)
    return Routing(probs, gate_vals, gate_idx, order, keep, slot, cap)


def moe_fwd(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss), through token groups of
    ``moe.scan_chunk`` (``_moe_chunked``)."""
    return _moe_chunked(cfg, p, x)


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
    """One token group.  x: (B, S, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    xt = x.reshape(t, d)
    r = route(cfg, p.router, xt)
    order = r.order.long()
    tok = order // k                       # the token of each sorted pair
    xe = D.scatter_rows(xt[tok], r.slot, r.keep, e * r.cap) \
        .reshape(e, r.cap, d)
    h = torch.bmm(xe, p.w_in.to(x.dtype))
    if cfg.gated_ffn:
        h = F.silu(torch.bmm(xe, p.w_gate.to(x.dtype))) * h
    else:
        h = F.silu(h)
    ye = torch.bmm(h, p.w_out.to(x.dtype))
    contrib = D.gather_rows(ye.reshape(e * r.cap, d), r.slot, r.keep) \
        * r.gate_vals.reshape(t * k)[order][:, None].to(ye.dtype)
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
