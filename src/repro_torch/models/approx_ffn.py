"""ApproxFFN — the paper's MCMA as an LM layer (counterpart of
``repro/models/approx_ffn.py``, serve path at layer scope).

The exact FFN is the target function; ``n_approx`` small identical-topology
tanh MLPs are the approximators; an (n+1)-way router is the multiclass
classifier (class 0 = exact).  Serving dispatches each token by the
router's argmax under static capacities (runtime/dispatch.mcma_dispatch):
class-0 tokens through the exact FFN (``exact_frac``·T of them), classes
1..n through their approximator (``invoke_frac``·T each), over-capacity
tokens contribute zero.

Routing is per layer (``route_scope="layer"``) or once per tick
(``"tick"``: ``make_tick_plan`` builds one plan from the model's
tick-router head, and every layer executes against it).  Per-request QoS
tiers add a per-tier margin to each row's exact-path logit; with an
approximator library (``approx.library_size > 0``) the router heads are
library-wide and a residency vector folds the library onto the resident
slots, whose weight rows each layer gathers.

Training (``approx_ffn_train``) follows the paper's competitive
co-training: the exact FFN runs on every token (the teacher, and the
layer's output), every approximator runs on every token, each token's
label is the approximator of least relative L2 error when that error is
within ``error_bound`` and class 0 (exact) otherwise, the router trains on
those labels and each approximator distils its own territory.

On a mesh (inside ``runtime/steps.serve_mesh_context``) the serve path is
one rank's part of the SPMD program (models/model.py): ``x`` holds the
rank's data shard of the rows, replicated over "model".  Each data shard
classifies, capacities, class-sorts and weight-switches its OWN rows
through the same engine, at per-shard capacities (``serve_caps`` of the
local row count), with no dispatch traffic between shards; the
approximators and routers are replicated and run locally; the exact FFN
runs Megatron-TP over "model" with one all-reduce a call
(layers.ffn_fwd: the weights' data-sharded dims gathered at use); and
the invoke stats are all-reduced over the data axes to global totals,
once a plan, so every rank reports the same.  ``_manual_serve_ctx`` is
the predicate under which that path serves.  A batch that does not divide
over the data axes is whole on every data rank: each classifies,
capacities and dispatches every row as one device, at one device's
capacities, and its stats are not all-reduced (``_stats_axes``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import LANE, _pad_to, gather_resident_stacks
from repro_torch.models.layers import FFN, draw, ffn_fwd, param
from repro_torch.runtime.dispatch import (execute_dispatch, make_dispatch_plan,
                                          mcma_dispatch, plan_invoke_stats)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import manual_dp_context, row_axes
from repro_torch.sharding.rules import dp_axes, shard_capacity


class ApproxFFN(nn.Module):
    """The exact FFN, the router head and the approximator stacks in
    SERVING form (kernels/ops.prepad_switched_weights): the zero nC
    pseudo-class last, feature dims lane-padded with exact zeros."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, a = cfg.d_model, cfg.approx
        n = a.n_live
        d_p, h_p = _pad_to(d, LANE), _pad_to(a.d_hidden, LANE)
        self.ffn = FFN(cfg, device, gen)
        self.router = param((d, n + 1), cfg.pdtype, device, gen, d ** -0.5)
        # initialized stacks start at zero (biases, padding, pseudo-class),
        # then the logical weight blocks are drawn
        fill = 0.0 if gen is not None else None
        self.a_w1 = param((n + 1, d_p, h_p), cfg.pdtype, device, fill=fill)
        self.a_b1 = param((n + 1, h_p), cfg.pdtype, device, fill=fill)
        self.a_w2 = param((n + 1, h_p, d_p), cfg.pdtype, device, fill=fill)
        self.a_b2 = param((n + 1, d_p), cfg.pdtype, device, fill=fill)
        if gen is not None:
            w1, _, w2, _ = approx_stacks(cfg, self)
            w1.copy_(draw(w1.shape, cfg.pdtype, device, gen, d ** -0.5))
            w2.copy_(draw(w2.shape, cfg.pdtype, device, gen,
                          a.d_hidden ** -0.5))


def init_approx_ffn(gen, cfg: ModelConfig, device) -> ApproxFFN:
    return ApproxFFN(cfg, device, gen)


def approx_stacks(cfg: ModelConfig, p: ApproxFFN):
    """Logical (n_live, d, d_hidden)-shaped views of the serving stacks."""
    a, d = cfg.approx, cfg.d_model
    n = a.n_live
    return (p.a_w1[:n, :d, :a.d_hidden], p.a_b1[:n, :a.d_hidden],
            p.a_w2[:n, :a.d_hidden, :d], p.a_b2[:n, :d])


def _apply_all_approx(cfg: ModelConfig, p: ApproxFFN, x: torch.Tensor):
    """All approximators on all tokens.  x: (T, d) -> (n, T, d)."""
    w1, b1, w2, b2 = approx_stacks(cfg, p)
    h = torch.einsum("td,ndh->nth", x, w1.to(x.dtype))
    h = torch.tanh(h + b1[:, None, :].to(x.dtype))
    y = torch.einsum("nth,nhd->ntd", h, w2.to(x.dtype))
    return y + b2[:, None, :].to(x.dtype)


def _rel_err(y_hat: torch.Tensor, y: torch.Tensor, eps: float = 1e-6):
    """Per-token relative L2 error (the competitive scheme's label
    signal), in f32."""
    d = (y_hat - y).float()
    num = torch.sqrt((d * d).sum(-1))
    yf = y.float()
    return num / torch.sqrt((yf * yf).sum(-1)).clamp(min=eps)


def approx_ffn_train(cfg: ModelConfig, p: ApproxFFN, x: torch.Tensor):
    """Training path.  x: (B, S, d) -> (exact FFN out, aux dict).

    aux: ``loss`` (router cross-entropy and distillation, weighted),
    ``invocation`` (the share of tokens whose best approximator is within
    the bound), ``router_acc`` and ``label_votes`` ((T, n+1) one-hot
    competitive labels, which the model sums over layers to train the
    tick-router head).  The stacks are read through their logical views
    (``approx_stacks``), so the padding and the pseudo-class get zero
    gradients.

    On a mesh (``runtime/steps.train_mesh_context``) ``x`` is the rank's
    rows: the exact FFN runs tensor-parallel, the labels, ``safe`` and
    the votes stay per token, and the losses and metrics are the global
    batch's, the same on every rank."""
    a = cfg.approx
    n = a.n_live
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    exact = ffn_fwd(cfg, p.ffn, xt)                         # (T, d) teacher
    approx = _apply_all_approx(cfg, p, xt)                  # (n, T, d)
    errs = _rel_err(approx, exact[None])                    # (n, T)

    # competitive labels: argmin error if under bound, else 0 (exact)
    best = errs.argmin(0)
    safe = errs.amin(0) <= a.error_bound
    labels = torch.where(safe, best + 1, 0)

    logits = (xt @ p.router.to(xt.dtype)).float()
    logp = F.log_softmax(logits, -1)
    router_loss = -logp.gather(1, labels[:, None]).mean()

    # distillation: each approximator fits its territory (the teacher is
    # not trained by it).  own[i, t] = token t's label is approximator i;
    # an exact-labelled token (label - 1 = -1) owns no row
    tgt = exact.detach().float()
    own = (torch.arange(n, device=x.device)[:, None] == (labels - 1)[None]) \
        .float() * safe.float()                             # (n, T)
    sq = ((approx.float() - tgt[None]) ** 2).sum(-1)        # (n, T)
    # territory tokens at weight 1; all tokens at small weight (exploration)
    w = own + 0.05
    num, den = (sq * w).sum(), w.sum()
    invocation = safe.float().mean()
    router_acc = (logits.argmax(-1) == labels).float().mean()
    mesh, dp = manual_dp_context()
    if mesh is not None:
        # the global values: the means over equal data shards, and the
        # distillation's ratio of global sums (per-shard ratios differ
        # when the territories are uneven)
        g = mesh.size(dp)
        router_loss, num, den, invocation, router_acc = C.all_reduce_sum(
            torch.stack([router_loss, num, den, invocation, router_acc]),
            dp).unbind()
        router_loss, invocation, router_acc = \
            router_loss / g, invocation / g, router_acc / g
    distill = num / den.clamp(min=1.0) / d

    aux = {"loss": a.router_weight * router_loss + a.distill_weight * distill,
           "invocation": invocation, "router_acc": router_acc,
           "label_votes": F.one_hot(labels, n + 1).float()}
    return exact.reshape(b, s, d), aux


def _manual_serve_ctx(cfg: ModelConfig, b: int, mesh):
    """(mesh, dp, n_data_shards) when the sharded serve path engages for
    a GLOBAL batch of ``b`` rows on ``mesh``, else (None, (), 1): the
    reference's predicate, ``b`` divides over the data axes and ``d_ff``
    over "model"."""
    if "model" not in mesh.axis_names:
        return None, (), 1
    dp = dp_axes(mesh)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    g = math.prod(sizes[ax] for ax in dp)
    if b % g == 0 and cfg.d_ff % sizes["model"] == 0:
        return mesh, dp, g
    return None, (), 1


def _stats_axes() -> tuple:
    """The axes a plan's stats are all-reduced over: the data axes inside
    a serve mesh context, none outside or where every data rank holds
    every row (a batch below the data axes, ``activations.whole_rows``:
    each rank's stats are then one device's, as ``_manual_serve_ctx``
    says for such a batch)."""
    return row_axes()


def serve_caps(cfg: ModelConfig, t_local: int):
    """(exact_cap, invoke_cap) for ``t_local`` rows — the one place the
    config's capacity fractions become row budgets (``invoke_cap`` is a
    per-class tuple when ``approx.invoke_fracs`` is set)."""
    a = cfg.approx
    ec = shard_capacity(t_local, a.exact_frac, slack=a.shard_slack)
    if a.invoke_fracs:
        assert len(a.invoke_fracs) == a.n_approx, \
            (a.invoke_fracs, a.n_approx)
        return ec, tuple(shard_capacity(t_local, f, slack=a.shard_slack)
                         for f in a.invoke_fracs)
    return ec, shard_capacity(t_local, a.invoke_frac, slack=a.shard_slack)


def _default_margins(cfg: ModelConfig, device) -> torch.Tensor:
    """The config's static per-tier margins (zeros when unset): what every
    serve path uses when a caller passes tiers without a margins vector."""
    a = cfg.approx
    return torch.tensor(a.tier_margins or (0.0,) * a.n_tiers,
                        dtype=torch.float32, device=device)


def _row_mask_tokens(row_mask, s: int):
    """Normalize an active mask to per-ROW (B*S,) bools: a per-slot (B,)
    mask repeats over the slot's S tokens; a (B, S) token mask flattens."""
    if row_mask is None:
        return None
    rm = row_mask.to(torch.bool)
    return rm.reshape(-1) if rm.ndim == 2 else rm.repeat_interleave(s)


def _tier_args(cfg: ModelConfig, tier, tier_margins, s: int):
    """Normalize the per-slot QoS args for a (B, S) row batch: the (B,)
    tier vector repeated over each slot's S rows, and the margins vector
    defaulted from the config when the caller passed tiers without one."""
    if tier is None:
        return None, None
    tr = tier.to(torch.int32).repeat_interleave(s)
    if tier_margins is None:
        tier_margins = _default_margins(cfg, tier.device)
    return tr, tier_margins


def make_tick_plan(cfg: ModelConfig, params, x: torch.Tensor,
                   row_mask: torch.Tensor | None = None,
                   tier: torch.Tensor | None = None,
                   tier_margins: torch.Tensor | None = None,
                   residency: torch.Tensor | None = None):
    """One DispatchPlan per tick (``route_scope="tick"``), single device.

    Classifies with the model's tick-router head (``params.tick_router``)
    on the pre-layer hidden state ``x`` (B, S, d), runs capacity and the
    class sort once, and returns the plan every layer executes against.
    ``row_mask`` is a per-slot (B,) or per-token (B, S) active mask.
    ``tier`` ((B,) int32) and ``tier_margins`` ((n_tiers,) float32) route
    each slot at its own error-bound tier, and the plan carries the
    per-tier split.  ``residency`` ((n_resident,) int32 library ids) folds
    the library-wide head's routing onto the resident slots; every layer
    then executes against stacks gathered with the same vector.  On a mesh
    the plan is the rank's data shard's, at per-shard capacities, with its
    counts all-reduced to global totals (module docstring)."""
    a = cfg.approx
    b, s, d = x.shape
    t = b * s
    router = getattr(params, "tick_router", None)
    if router is None:
        raise ValueError("route_scope='tick' needs the tick-router head, "
                         "but these params have none")
    xt = x.reshape(t, d)
    logits = (xt @ router.to(xt.dtype)).float()
    tr, tier_margins = _tier_args(cfg, tier, tier_margins, s)
    ec, ic = serve_caps(cfg, t)
    return make_dispatch_plan(
        logits, _row_mask_tokens(row_mask, s), exact_cap=ec, invoke_cap=ic,
        backend=a.backend, block_t=a.block_t, stats_axes=_stats_axes(),
        tier=tr, tier_margins=tier_margins, residency=residency)


def execute_plan(cfg: ModelConfig, p: ApproxFFN, x: torch.Tensor, plan,
                 residency: torch.Tensor | None = None):
    """This layer's ApproxFFN against a tick plan: the exact FFN on the
    plan's exact rows and one weight-switch launch over its class-sorted
    rows; no router, sort or stats here.  ``residency`` (library serving:
    the vector the plan was built with) gathers the resident rows of the
    library stacks first.  x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    stacks = (p.a_w1, p.a_b1, p.a_w2, p.a_b2)
    if residency is not None:
        stacks = gather_resident_stacks(*stacks, residency)
    out = execute_dispatch(plan, x.reshape(b * s, d),
                           lambda xb: ffn_fwd(cfg, p.ffn, xb),
                           *stacks, weights_prepadded=True)
    return out.reshape(b, s, d)


def approx_ffn_serve(cfg: ModelConfig, p: ApproxFFN, x: torch.Tensor,
                     row_mask: torch.Tensor | None = None, plan=None,
                     tier: torch.Tensor | None = None,
                     tier_margins: torch.Tensor | None = None,
                     residency: torch.Tensor | None = None):
    """Serving path with capacity dispatch.  x: (B, S, d) -> (out, aux).

    ``row_mask`` ((B,) or (B, S) bool) marks the ACTIVE rows; idle rows
    are excluded from dispatch and from every invoke stat.  ``tier``
    ((B,) int32) and ``tier_margins`` ((n_tiers,) float32): per-request
    QoS, each slot routed at its own tier's exact-logit margin, the
    invoke stats split per tier.  ``residency`` ((n_resident,) int32
    library ids): the stacks and router hold the full library; the
    resident rows are gathered per call (ops.gather_resident_stacks) and
    library routing folds onto the resident slots.  ``plan`` (a tick plan
    from ``make_tick_plan``): the routing decision was made once above the
    layers and this layer only executes against it (``row_mask`` and
    ``tier`` are ignored: the plan embeds them; ``residency`` only picks
    the executed weights and must be the plan's).  The engine is
    ``runtime/dispatch.mcma_dispatch``; ``cfg.approx.backend`` picks the
    executor ("pallas" = switched CUDA kernel, "pallas_fused" = fused CUDA
    kernel, "xla" = eager oracle)."""
    a = cfg.approx
    b, s, d = x.shape
    t = b * s
    if plan is not None:
        return (execute_plan(cfg, p, x, plan, residency),
                _aux(plan_invoke_stats(plan), x.device))
    xt = x.reshape(t, d)
    tr, tier_margins = _tier_args(cfg, tier, tier_margins, s)
    ec, ic = serve_caps(cfg, t)
    logits = (xt @ p.router.to(x.dtype)).float()
    out, stats = mcma_dispatch(
        xt, logits, lambda xb: ffn_fwd(cfg, p.ffn, xb),
        p.a_w1, p.a_b1, p.a_w2, p.a_b2, exact_cap=ec, invoke_cap=ic,
        backend=a.backend, block_t=a.block_t, stats_axes=_stats_axes(),
        row_mask=_row_mask_tokens(row_mask, s), weights_prepadded=True,
        tier=tr, tier_margins=tier_margins, residency=residency)
    return out.reshape(b, s, d), _aux(stats, x.device)


def _aux(stats, device) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": zero, "invocation": stats["invocation"],
            "router_acc": zero, "invoke_stats": stats}
