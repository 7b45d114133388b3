"""Step functions (counterpart of ``repro/runtime/steps.py``).

``make_train_step(cfg)``   -> ``(state, batch) -> (state, metrics)``
``make_prefill_step(cfg)`` -> ``(params, batch) -> (last_logits, cache)``
``make_decode_step(cfg)``  -> ``(params, cache, inputs, row_mask=None,
tier=None, tier_margins=None, residency=None) -> (logits, cache[,
metrics])``
``make_prefill_chunk_step(cfg)`` -> ``(params, cache, tokens, n_valid,
row_mask=None, tier=None, tier_margins=None, residency=None) -> (cache,
metrics)``.  PyTorch runs eagerly, so a step is
a plain closure over the config; the serve steps run under
``torch.no_grad``.

The train step is microbatched forward and backward (gradients summed in
float32 over ``grad_accum`` slices of the batch, then divided), global-norm
clipping, the cosine learning rate and AdamW; inside
``train_mesh_context(mesh)`` it is one rank's part of the same step on a
("data", "model") mesh.  The train state is
``{"params": Model, "opt": {"m", "v"}, "step"}`` and the step updates it
in place: the moments and the parameters are written where they lie.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import decay_mask
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule)
from repro_torch.runtime.dispatch import DISPATCH_BACKENDS
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import manual_dp_context, mesh_context


def init_train_state(key, cfg: ModelConfig, *, device=None,
                     mesh=None) -> dict:
    """Random parameters from ``key`` (an int seed or a ``torch.Generator``)
    with gradients on, zero float32 AdamW moments and step 0, on
    ``device`` (default: the GPU, which must exist).  On ``mesh`` each
    parameter is this rank's shard of the same draw
    (``model.init_model(mesh=)``), and the moments are shards too."""
    params = M.init_model(key, cfg, device=resolve_device(device),
                          mesh=mesh)
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    return {"params": params, "opt": adamw_init(named),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(named.values())).device)}


def _reduce_over_data(named: dict, grads: dict, mesh, dp) -> dict:
    """Each rank's gradients as the sums over the data ranks: a leaf that
    ``unshard`` gathered has its sum from the reduce-scatter already; the
    leaves replicated over the data axes are all-reduced, in one
    collective per dtype."""
    rep = [k for k, p in named.items() if not C._dp_dims(p._pspec, dp)]
    summed = C.all_reduce_sum_many([grads[k] for k in rep], dp, mesh)
    return dict(grads, **dict(zip(rep, summed)))


def loss_and_grads(cfg: ModelConfig, params, batch, grad_accum: int = 1):
    """The train step's forward and backward: returns (loss, metrics,
    {name: gradient}), all detached.  With ``grad_accum > 1`` the batch
    splits into equal slices along B, the gradients are summed in float32
    zeros and divided by ``grad_accum``, and the loss and every metric
    are the mean of the slices' (equal slices: for a token-meaned metric,
    the full-batch value).

    Inside ``train_mesh_context`` ``batch`` is this rank's rows
    (``data/pipeline.local_batch``: its rows of each global microbatch,
    in microbatch order, so slice i of them is its part of the single
    device's slice i; a microbatch below the data axes, given as
    ``train_mesh_context(mesh, microbatch)``, is every row and the rank's
    slice of the positions), ``params`` its shards, and the result is the
    single device's: the global loss and metrics on every rank, and each
    gradient this rank's shard of the single device's gradient (the
    losses are global means, so a sum over the data ranks is the whole
    gradient: ``_reduce_over_data``)."""
    loss, metrics, grads = _rank_loss_and_grads(cfg, params, batch,
                                                grad_accum)
    mesh, dp = manual_dp_context()
    if mesh is not None:
        grads = _reduce_over_data(dict(params.named_parameters()), grads,
                                  mesh, dp)
    return loss, metrics, grads


def _rank_loss_and_grads(cfg: ModelConfig, params, batch, grad_accum: int):
    """``loss_and_grads`` on this rank's rows, before the gradients'
    reduction over the data axes."""
    named = dict(params.named_parameters())
    inputs, labels = batch["inputs"], batch["labels"]

    def grads_of(inp, lab):
        loss, metrics = M.lm_loss(cfg, params, inp, lab)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
        gs = {k: torch.zeros_like(p) if g is None else g
              for (k, p), g in zip(named.items(), gs)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    if grad_accum == 1:
        return grads_of(inputs, labels)
    mb = inputs.shape[0] // grad_accum
    if mb * grad_accum != inputs.shape[0]:
        raise ValueError(f"batch of {inputs.shape[0]} rows does not split "
                         f"into grad_accum={grad_accum} equal slices")
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in named.items()}
    lsum, ms = 0.0, []
    for i in range(grad_accum):
        sl = slice(i * mb, (i + 1) * mb)
        loss, m, gs = grads_of(inputs[sl], labels[sl])
        for k, g in gs.items():
            acc[k].add_(g)
        del gs
        lsum = lsum + loss
        ms.append(m)
    for g in acc.values():
        g.div_(grad_accum)
    metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
    return lsum / grad_accum, metrics, acc


def make_train_step(cfg: ModelConfig, *, grad_accum: int = 1,
                    base_lr: float = 3e-4, warmup: int = 200,
                    total_steps: int = 10_000, max_grad_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics).  ``batch`` =
    {"inputs": (B, S), "labels": (B, S)} on the state's device; B must
    divide by grad_accum.  The metrics are the forward's (layer-meaned)
    plus ``loss``, ``grad_norm`` (before clipping) and ``lr``, as tensors
    on the device: reading one is the caller's host sync.  The cosine
    schedule gives lr 0 at step 0 when ``warmup > 0``.  Inside
    ``train_mesh_context`` the state is this rank's shards and the batch
    its rows (``loss_and_grads``); the norm is clipped over the shards
    and AdamW updates each rank's shards, so the result is the single
    device's step, every metric the same on every rank."""
    decay = {}

    def train_step(state, batch):
        params = state["params"]
        if not decay:       # the reference's rank rule, from its layout
            decay.update(decay_mask(cfg, params))
        loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                              grad_accum)
        mesh, _ = manual_dp_context()
        specs = None if mesh is None else {
            k: p._pspec for k, p in params.named_parameters()}
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, mesh=mesh,
                                           specs=specs)
        lr = cosine_schedule(state["step"], base_lr=base_lr, warmup=warmup,
                             total=total_steps)
        adamw_update(dict(params.named_parameters()), grads, state["opt"],
                     state["step"], lr=lr, decay=decay)
        new_state = {"params": params, "opt": state["opt"],
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """Prefill over ``batch["inputs"]`` (B, S) tokens: the last position's
    logits and the decode cache after S tokens (``pos = S``; a dense
    family's KV length is S, ``model.pad_cache`` grows it)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache, _, _ = M.forward(cfg, params, batch["inputs"],
                                            collect_cache=True, serve=True)
        return logits[:, -1], cache
    return prefill_step


def mcma_serve_config(cfg: ModelConfig, *,
                      backend: str | None = None) -> ModelConfig:
    """Serve-mode cfg routing the ApproxFFN through the MCMA dispatch
    engine (runtime/dispatch.py).  Default backend "pallas" (the switched
    CUDA kernel); "pallas_fused" runs the fused CUDA kernel; "xla" the
    eager per-class oracle."""
    assert cfg.approx.enable, "MCMA dispatch requires cfg.approx.enable"
    backend = backend or "pallas"
    if backend not in DISPATCH_BACKENDS:
        raise ValueError(f"unknown dispatch backend: {backend!r}")
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, backend=backend))


# The serve and the train context of a mesh deployment are one context
# manager, ``sharding/activations.mesh_context``: the mesh and the
# batch-sharded activation spec, which the model code reads to run as this
# rank's part of the SPMD program.  Served, every call of a mesh server's
# steps (and ``init_cache`` / ``reset_slot``) runs inside it: the dispatch
# engine per data shard with all-reduced stats, tensor parallelism over
# "model".  Trained, ``loss_and_grads`` and ``make_train_step`` run inside
# it on the rank's rows of the batch (``train_mesh_context(mesh,
# microbatch)``: below the data axes its slice of the positions,
# ``activations.sequence_split``), tensor-parallel over "model", and
# return the single device's gradients of the global loss, each rank its
# shards.  ``mesh=None`` is a no-op, so single-device callers share the
# code path.
serve_mesh_context = train_mesh_context = mesh_context


def _serve_cfg(cfg: ModelConfig, *, use_mcma_dispatch: bool,
               operating_point, route_scope: str | None,
               backend: str | None) -> ModelConfig:
    """Shared cfg munging for the serve-mode steps: MCMA backend
    selection, the route-scope override and an operating point's
    capacities.  Both steps come out of the same cfg, so a prefill chunk
    and a decode tick dispatch alike."""
    if use_mcma_dispatch:
        cfg = mcma_serve_config(cfg, backend=backend)
    if route_scope is not None:
        if route_scope not in ("layer", "tick"):
            raise ValueError(f"unknown route_scope: {route_scope!r} "
                             "(expected 'layer' or 'tick')")
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, route_scope=route_scope))
    if operating_point is not None:
        pt = operating_point
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, exact_frac=pt.exact_frac,
            invoke_frac=pt.invoke_frac, shard_slack=pt.shard_slack,
            invoke_fracs=tuple(pt.invoke_fracs),
            tier_margins=tuple(pt.tier_margins) or cfg.approx.tier_margins))
    return cfg


def make_decode_step(cfg: ModelConfig, *, use_mcma_dispatch: bool = False,
                     with_stats: bool = False, operating_point=None,
                     route_scope: str | None = None,
                     backend: str | None = None):
    """``use_mcma_dispatch`` serves the ApproxFFN through the MCMA dispatch
    engine; ``with_stats`` makes the step also return the tick's dispatch
    metrics (the layer mean; under ``route_scope="tick"`` the one plan's
    stats).  ``operating_point`` (runtime/autotune.OperatingPoint)
    replaces the config's capacity fractions: a capacity rung is its own
    step.  ``route_scope`` overrides the config's ("layer" or "tick").

    The step takes ``(params, cache, inputs, row_mask=None, tier=None,
    tier_margins=None, residency=None)``: ``row_mask`` ((B,) bool of
    ACTIVE slots), ``tier`` ((B,) int32 QoS tier per slot) with
    ``tier_margins`` ((n_tiers,) float32), and ``residency``
    ((n_resident,) int32 library ids, library configs only) — all tensor
    data, so one step serves every tier mix, margin and hot set.  It
    updates the cache in place (models/model.decode)."""
    cfg = _serve_cfg(cfg, use_mcma_dispatch=use_mcma_dispatch,
                     operating_point=operating_point,
                     route_scope=route_scope, backend=backend)

    def decode_step(params, cache, inputs, row_mask=None, tier=None,
                    tier_margins=None, residency=None):
        with torch.no_grad():
            return M.decode(cfg, params, cache, inputs, serve=True,
                            collect_metrics=with_stats, row_mask=row_mask,
                            tier=tier, tier_margins=tier_margins,
                            residency=residency)
    return decode_step


def make_prefill_chunk_step(cfg: ModelConfig, *,
                            use_mcma_dispatch: bool = False,
                            with_stats: bool = False, operating_point=None,
                            route_scope: str | None = None,
                            backend: str | None = None):
    """Chunked-prefill step: up to S prompt tokens per slot into the SAME
    decode cache (dense or paged) that ``make_decode_step`` advances,
    without logits (models/model.decode_chunk).  Takes ``(params, cache,
    tokens (B, S) int32 right-padded, n_valid (B,) int32, row_mask=None,
    tier=None, tier_margins=None, residency=None)`` and returns ``(cache,
    metrics)``, the cache updated in place.  Shares ``_serve_cfg`` with
    ``make_decode_step``, so both phases run the same dispatch
    configuration; its metrics are the chunk's, to be kept apart from the
    decode ticks'.  Uniform (dense-attention) family only."""
    cfg = _serve_cfg(cfg, use_mcma_dispatch=use_mcma_dispatch,
                     operating_point=operating_point,
                     route_scope=route_scope, backend=backend)

    def prefill_chunk_step(params, cache, tokens, n_valid, row_mask=None,
                           tier=None, tier_margins=None, residency=None):
        with torch.no_grad():
            return M.decode_chunk(cfg, params, cache, tokens, n_valid,
                                  serve=True, collect_metrics=with_stats,
                                  row_mask=row_mask, tier=tier,
                                  tier_margins=tier_margins,
                                  residency=residency)
    return prefill_chunk_step
