"""Serve-mode step functions (counterpart of the serve half of
``repro/runtime/steps.py``).

``make_prefill_step(cfg)`` -> ``(params, batch) -> (last_logits, cache)``
``make_decode_step(cfg)``  -> ``(params, cache, inputs, row_mask=None,
tier=None, tier_margins=None, residency=None) -> (logits, cache[,
metrics])``
``make_prefill_chunk_step(cfg)`` -> ``(params, cache, tokens, n_valid,
row_mask=None, tier=None, tier_margins=None, residency=None) -> (cache,
metrics)``.  PyTorch runs eagerly, so a step is
a plain closure over the serve config, run under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.runtime.dispatch import DISPATCH_BACKENDS


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
