"""Model assembly (counterpart of ``repro/models/model.py``), dense family:
N x (attention + FFN) blocks held in an ``nn.ModuleList``, applied in a
Python loop where the reference scans over stacked parameters.

``Model``'s parameter names are the reference's pytree keys with the
stacked ``blocks`` leaves split per layer (``blocks.<i>.attn.wq``), so
``convert.params_from_jax`` loads a JAX checkpoint leaf by leaf.  Other
families (MoE, SSM, hybrid) and the train/prefill forward are not ported
yet (ROADMAP queue 1, items 5 and 9).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.approx_ffn import ApproxFFN, approx_ffn_serve


def _check_supported(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.moe.n_experts or cfg.parallel_block:
        raise NotImplementedError(
            f"model family {cfg.family!r} (moe={cfg.moe.n_experts}, "
            f"parallel_block={cfg.parallel_block}) is not ported yet; the "
            "port serves the dense family (ROADMAP queue 1, item 9)")


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, cfg.d_model, device)
        self.attn = L.Attention(cfg, device, gen)
        self.ln2 = L.Norm(cfg, cfg.d_model, device)
        if cfg.approx.enable:
            self.approx = ApproxFFN(cfg, device, gen)
        else:
            self.ffn = L.FFN(cfg, device, gen)


class Model(nn.Module):
    """The dense LM's parameters.  Built without a generator the storage
    is uninitialized (for loading); ``init_model`` initializes it."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        _check_supported(cfg)
        self.embed = L.Embed(cfg, device, gen)
        self.ln_f = L.Norm(cfg, cfg.d_model, device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        if cfg.approx.enable:
            # tick-router head (route_scope="tick"), carried so that
            # conversion of a reference checkpoint is total
            self.tick_router = L.param(
                (cfg.d_model, cfg.approx.n_live + 1), cfg.pdtype, device,
                gen, cfg.d_model ** -0.5)


def init_model(key, cfg: ModelConfig, *, device=None) -> Model:
    """Random parameters from ``key``, an int seed or a ``torch.Generator``
    on ``device`` (default: the GPU, which must exist)."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) \
        else torch.Generator(device=dev).manual_seed(int(key))
    return Model(cfg, dev, gen)


def _dense_block(cfg: ModelConfig, p: DenseBlock, x, positions, cache, *,
                 serve=False, row_mask=None):
    """One transformer block.  Returns (x, new_cache, aux_loss, metrics)."""
    h, new_cache = L.attention_fwd(cfg, p.attn, L.norm_fwd(cfg, p.ln1, x),
                                   positions, cache)
    x = x + h
    f, aux, metrics = _ffn_part(cfg, p, L.norm_fwd(cfg, p.ln2, x), serve,
                                row_mask)
    return x + f, new_cache, aux, metrics


def _ffn_part(cfg: ModelConfig, p: DenseBlock, xn, serve, row_mask=None):
    zero = torch.zeros((), dtype=torch.float32, device=xn.device)
    if not cfg.approx.enable:
        return L.ffn_fwd(cfg, p.ffn, xn), zero, {}
    if not serve:
        raise NotImplementedError("the ApproxFFN co-training path is not "
                                  "ported yet (ROADMAP queue 1, item 5)")
    y, a = approx_ffn_serve(cfg, p.approx, xn, row_mask=row_mask)
    st = a["invoke_stats"]
    total = st["class_counts"].sum().clamp(min=1).float()
    m = {"invocation": a["invocation"], "router_acc": a["router_acc"],
         "exact_frac": st["exact_frac"],
         "dropped_frac": st["dropped"].float() / total,
         "padding_rows": st["padding_rows"].float(),
         "class_counts": st["class_counts"].float(),
         "dispatched": st["dispatched"].float(),
         "dropped_rows": st["dropped"].float(),
         "tier_counts": st["tier_counts"].float(),
         "tier_dispatched": st["tier_dispatched"].float(),
         "lib_counts": st["lib_counts"].float(),
         "off_set_exact_rows": st["off_set_exact_rows"].float()}
    return y, a["loss"], m


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Empty dense decode cache: k/v (L, batch, max_len, Kh, hd), pos (batch,).
    The paged layout is not ported yet (ROADMAP queue 1, item 5)."""
    _check_supported(cfg)
    c = L.init_attn_cache(cfg, batch, max_len, resolve_device(device))
    stack = lambda a: a[None].repeat(cfg.n_layers, *([1] * a.ndim))
    return {"k": stack(c["k"]), "v": stack(c["v"]), "pos": c["pos"]}


def reset_slot(cfg: ModelConfig, cache, fresh, slot: int):
    """Reset batch slot ``slot`` of a decode cache to ``fresh`` (a cache
    from init_cache), IN PLACE, and return the cache."""
    cache["k"][:, slot] = fresh["k"][:, slot]
    cache["v"][:, slot] = fresh["v"][:, slot]
    cache["pos"][slot] = fresh["pos"][slot]
    return cache


def decode(cfg: ModelConfig, params: Model, cache, inputs: torch.Tensor, *,
           serve: bool = True, collect_metrics: bool = False,
           row_mask: torch.Tensor | None = None):
    """One decode step.  inputs: tokens (B, 1).  Returns (logits (B, V),
    cache), or (logits, cache, metrics) when ``collect_metrics`` — the
    layer-meaned ApproxFFN dispatch metrics.

    The KV cache is updated IN PLACE and returned with ``pos`` advanced
    (the reference donates its cache and returns an updated one).
    ``row_mask`` ((B,) bool) marks the ACTIVE slots: idle slots are
    excluded from the dispatch and its stats, and their ``pos`` holds.
    Every slot's ``pos`` must be below the cache length (checked here;
    the reference would clamp the write)."""
    if serve and cfg.approx.enable and cfg.approx.route_scope != "layer":
        raise NotImplementedError(
            f"route_scope={cfg.approx.route_scope!r} is not ported yet; "
            "the port routes per layer (ROADMAP queue 1, item 5)")
    x = L.embed_fwd(cfg, params.embed, inputs)
    pos = cache["pos"]
    skv = cache["k"].shape[2]
    if int(pos.max()) >= skv:
        raise ValueError(f"decode past the cache end: pos {pos.tolist()} "
                         f"with max_len {skv}")
    positions = pos[:, None]
    per_layer = []
    for i, blk in enumerate(params.blocks):
        lc = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        x, _, _, m = _dense_block(cfg, blk, x, positions, lc, serve=serve,
                                  row_mask=row_mask)
        per_layer.append(m)
    adv = 1 if row_mask is None else row_mask.to(torch.int32)
    cache["pos"] = (pos + adv).to(torch.int32)
    x = L.norm_fwd(cfg, params.ln_f, x)
    logits = L.unembed_fwd(cfg, params.embed, x)[:, 0]
    if not collect_metrics:
        return logits, cache
    metrics = {}
    if per_layer and per_layer[0]:
        metrics = {k: torch.stack([m[k] for m in per_layer]).mean(0)
                   for k in per_layer[0]}
    return logits, cache, metrics
