"""ApproxFFN — the paper's MCMA as an LM layer (counterpart of
``repro/models/approx_ffn.py``, serve path at layer scope).

The exact FFN is the target function; ``n_approx`` small identical-topology
tanh MLPs are the approximators; an (n+1)-way router is the multiclass
classifier (class 0 = exact).  Serving dispatches each token by the
router's argmax under static capacities (runtime/dispatch.mcma_dispatch):
class-0 tokens through the exact FFN (``exact_frac``·T of them), classes
1..n through their approximator (``invoke_frac``·T each), over-capacity
tokens contribute zero.

The co-training path, tick-scope plans and the sharded serve path are
not ported yet (ROADMAP queue 1, items 5 and 10).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import LANE, _pad_to
from repro_torch.models.layers import FFN, ffn_fwd, param
from repro_torch.runtime.dispatch import mcma_dispatch
from repro_torch.sharding.rules import shard_capacity


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
            w1.copy_(param(w1.shape, cfg.pdtype, device, gen, d ** -0.5))
            w2.copy_(param(w2.shape, cfg.pdtype, device, gen,
                           a.d_hidden ** -0.5))


def init_approx_ffn(gen, cfg: ModelConfig, device) -> ApproxFFN:
    return ApproxFFN(cfg, device, gen)


def approx_stacks(cfg: ModelConfig, p: ApproxFFN):
    """Logical (n_live, d, d_hidden)-shaped views of the serving stacks."""
    a, d = cfg.approx, cfg.d_model
    n = a.n_live
    return (p.a_w1[:n, :d, :a.d_hidden], p.a_b1[:n, :a.d_hidden],
            p.a_w2[:n, :a.d_hidden, :d], p.a_b2[:n, :d])


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


def _row_mask_tokens(row_mask, s: int):
    """Normalize an active mask to per-ROW (B*S,) bools: a per-slot (B,)
    mask repeats over the slot's S tokens; a (B, S) token mask flattens."""
    if row_mask is None:
        return None
    rm = row_mask.to(torch.bool)
    return rm.reshape(-1) if rm.ndim == 2 else rm.repeat_interleave(s)


def approx_ffn_serve(cfg: ModelConfig, p: ApproxFFN, x: torch.Tensor,
                     row_mask: torch.Tensor | None = None):
    """Serving path with capacity dispatch.  x: (B, S, d) -> (out, aux).

    ``row_mask`` ((B,) bool) marks the ACTIVE batch rows; idle rows are
    excluded from dispatch and from every invoke stat.  The engine is
    ``runtime/dispatch.mcma_dispatch``; ``cfg.approx.backend`` picks the
    executor ("pallas" = switched CUDA kernel, "pallas_fused" = fused CUDA
    kernel, "xla" = eager oracle)."""
    a = cfg.approx
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    ec, ic = serve_caps(cfg, t)
    logits = (xt @ p.router.to(x.dtype)).float()
    out, stats = mcma_dispatch(
        xt, logits, lambda xb: ffn_fwd(cfg, p.ffn, xb),
        p.a_w1, p.a_b1, p.a_w2, p.a_b2, exact_cap=ec, invoke_cap=ic,
        backend=a.backend, block_t=a.block_t,
        row_mask=_row_mask_tokens(row_mask, s), weights_prepadded=True)
    aux = {"loss": torch.zeros((), dtype=torch.float32, device=x.device),
           "invocation": stats["invocation"],
           "router_acc": torch.zeros((), dtype=torch.float32,
                                     device=x.device),
           "invoke_stats": stats}
    return out.reshape(b, s, d), aux
