"""Optimizers (counterpart of ``repro/optim/optimizers.py``): AdamW for
the LM framework, RMSprop for the paper pipeline, global-norm clipping and
the cosine schedule.

Parameters, gradients and moments are flat mappings of names to tensors
(``dict(model.named_parameters())`` and dicts shaped like it).  Moments
are float32 whatever the parameter dtype, and the update math runs in
float32 before the result is cast back to the parameter's dtype.  The
updates write into the given parameter and moment tensors (under
``torch.no_grad``) and return them: at full width a second copy of the
model and its moments would not fit beside the first.
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding import collectives as C


def _f32_like(params):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params):
    return {"m": _f32_like(params), "v": _f32_like(params)}


@torch.no_grad()
def adamw_update(params, grads, opt, step, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, decay=None):
    """One AdamW step at ``step`` (an int32 tensor; ``t = step + 1``), with
    ``lr`` a float32 tensor or a float.  ``decay`` maps each name to
    whether its parameter takes weight decay; without it a parameter of
    rank >= 2 does (matrices decayed, norms and biases exempt), the
    reference's rule on its own leaves.  The reference's leaves are
    STACKED over layers, so a per-layer norm scale of shape (d,) is an
    (L, d) leaf there and decayed: a split model passes the reference's
    mask (``convert.decay_mask``)."""
    dev = next(iter(params.values())).device
    t = (torch.as_tensor(step, device=dev) + 1).to(torch.float32)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    m_all, v_all = opt["m"], opt["v"]
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m, v = m_all[k], v_all[k]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if (decay[k] if decay is not None else p.ndim >= 2):
            step_ = step_ + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step_).to(p.dtype))
    return params, opt


# ---------------------------------------------------------------------------
# RMSprop (paper setup)
# ---------------------------------------------------------------------------

def rmsprop_init(params):
    return {"ms": _f32_like(params)}


@torch.no_grad()
def rmsprop_update(params, grads, opt, *, lr, decay=0.9, eps=1e-8):
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        ms = opt["ms"][k]
        ms.mul_(decay).add_((1 - decay) * g32 ** 2)
        p.copy_((p.to(torch.float32) - lr * g32 / (torch.sqrt(ms) + eps))
                .to(p.dtype))
    return params, opt


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *, mesh=None, specs=None):
    """Scales the gradients IN PLACE so their global norm is at most
    ``max_norm`` (each scaled in float32 and cast back to its dtype) and
    returns (them, the norm before scaling as a float32 tensor).

    On ``mesh`` the gradients are this rank's shards and ``specs`` their
    PartitionSpecs: each leaf's squared sum is taken over its shard and
    summed over exactly the axes its spec shards (a replicated leaf
    counted once), so every rank gets the same, global norm."""
    if mesh is None:
        norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                              for g in grads.values()))
    else:
        norm = torch.sqrt(_sharded_sq_sum(grads, mesh, specs))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return grads, norm


def _sharded_sq_sum(grads, mesh, specs):
    """The squared sum of sharded gradients: the leaves grouped by the
    axes their specs shard, each group's local sum summed over those
    axes, the groups added in one order on every rank."""
    groups: dict = {}
    for k, g in grads.items():
        groups.setdefault(C.spec_axes(mesh, specs[k]), []).append(
            torch.sum(g.to(torch.float32) ** 2))
    total = 0.0
    for axes in sorted(groups):
        part = torch.stack(groups[axes]).sum()
        for ax in axes:
            part = C.all_reduce_sum(part, ax, mesh)
        total = total + part
    return total


def cosine_schedule(step, *, base_lr, warmup, total):
    """Linear warmup over ``warmup`` steps (0 at step 0), then a cosine
    from ``base_lr`` to 0 at ``total``; a float32 tensor on the step's
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
