"""Model assembly (counterpart of ``repro/models/model.py``), two families:

  dense      : N x (attn + FFN)                 (decode)
  ssm (xLSTM): G x ((k-1) mLSTM + 1 sLSTM)      (prefill forward + decode)
               (k = ssm.slstm_every)

Blocks are held in ``nn.ModuleList``s and applied in Python loops where
the reference scans over stacked parameters.  ``Model``'s parameter names
are the reference's pytree keys with the stacked leaves split per layer
(``blocks.<i>.attn.wq``, ``mlstm.<g>.<p>.core.w_q``, ``slstm.<g>.ln.scale``),
so ``convert.params_from_jax`` loads a JAX checkpoint leaf by leaf.  The
MoE and hybrid families, the dense forward and training are not ported yet
(ROADMAP queue 1, items 5 and 9).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import xlstm
from repro_torch.models.approx_ffn import ApproxFFN, approx_ffn_serve


def _check_supported(cfg: ModelConfig):
    if cfg.family not in ("dense", "ssm") or cfg.moe.n_experts \
            or cfg.parallel_block:
        raise NotImplementedError(
            f"model family {cfg.family!r} (moe={cfg.moe.n_experts}, "
            f"parallel_block={cfg.parallel_block}) is not ported yet; the "
            "port serves the dense and xLSTM families (ROADMAP queue 1, "
            "item 9)")


@dataclasses.dataclass(frozen=True)
class Topology:
    """How layers group into block stacks for a family."""

    kind: str            # "uniform" | "xlstm" (the hybrid is not ported)
    n_groups: int = 0
    per_group: int = 0   # inner homogeneous run length


def topology(cfg: ModelConfig) -> Topology:
    if cfg.family == "ssm":
        k = cfg.ssm.slstm_every
        assert cfg.n_layers % k == 0, (cfg.n_layers, k)
        return Topology("xlstm", cfg.n_layers // k, k - 1)
    return Topology("uniform", cfg.n_layers, 1)


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


class MLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln = L.Norm(cfg, cfg.d_model, device)
        self.core = xlstm.MLSTM(cfg, device, gen)


class SLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln = L.Norm(cfg, cfg.d_model, device)
        self.core = xlstm.SLSTM(cfg, device, gen)


class Model(nn.Module):
    """The LM's parameters.  Built without a generator the storage is
    uninitialized (for loading); ``init_model`` initializes it."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        _check_supported(cfg)
        topo = topology(cfg)
        self.embed = L.Embed(cfg, device, gen)
        self.ln_f = L.Norm(cfg, cfg.d_model, device)
        if topo.kind == "xlstm":
            # mlstm.<g>.<p>: G groups of P mLSTM blocks; slstm.<g>: one each
            self.mlstm = nn.ModuleList(
                nn.ModuleList(MLSTMBlock(cfg, device, gen)
                              for _ in range(topo.per_group))
                for _ in range(topo.n_groups))
            self.slstm = nn.ModuleList(SLSTMBlock(cfg, device, gen)
                                       for _ in range(topo.n_groups))
            return
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


# ---- xLSTM ---------------------------------------------------------------

def _mlstm_block(cfg: ModelConfig, p: MLSTMBlock, x, state):
    y, st = xlstm.mlstm_fwd(cfg, p.core, L.norm_fwd(cfg, p.ln, x), state)
    return x + y, st


def _slstm_block(cfg: ModelConfig, p: SLSTMBlock, x, state):
    y, st = xlstm.slstm_fwd(cfg, p.core, L.norm_fwd(cfg, p.ln, x), state)
    return x + y, st


def forward(cfg: ModelConfig, params: Model, inputs: torch.Tensor, *,
            collect_cache: bool = False, serve: bool = False):
    """Full-sequence forward of the xLSTM family.  inputs: tokens (B, S).

    Returns (logits (B, S, V), cache-or-None, aux_loss, metrics).  With
    ``collect_cache`` the cache holds every block's final state, stacked
    as init_cache lays it out, and ``pos = S``.  ``serve`` changes nothing
    for this family (it has no ApproxFFN)."""
    if topology(cfg).kind != "xlstm":
        raise NotImplementedError(
            f"the {cfg.family!r} forward (train / prefill) is not ported "
            "yet (ROADMAP queue 1, item 5)")
    x = L.embed_fwd(cfg, params.embed, inputs)
    b, s = x.shape[0], x.shape[1]
    mstates, sstates = [], []
    for mblks, sblk in zip(params.mlstm, params.slstm):
        msts = []
        for blk in mblks:
            x, st = _mlstm_block(cfg, blk, x, None)
            msts.append(st)
        x, sst = _slstm_block(cfg, sblk, x, None)
        if collect_cache:
            mstates.append(msts)
            sstates.append(sst)
    cache = None
    if collect_cache:
        cache = {"mlstm": {k: torch.stack([torch.stack([st[k] for st in g])
                                           for g in mstates])
                           for k in ("c", "n")},
                 "slstm": {k: torch.stack([st[k] for st in sstates])
                           for k in ("h", "c", "n", "m")},
                 "pos": torch.full((b,), s, dtype=torch.int32,
                                   device=x.device)}
    x = L.norm_fwd(cfg, params.ln_f, x)
    logits = L.unembed_fwd(cfg, params.embed, x)
    return logits, cache, torch.zeros((), dtype=torch.float32,
                                      device=x.device), {}


# ---------------------------------------------------------------------------
# Decode (single token, cache update)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Empty decode cache.  Dense: k/v (L, batch, max_len, Kh, hd); xLSTM:
    the mLSTM states (G, P, batch, ...) and the sLSTM states (G, batch,
    ...), whatever ``max_len``; both with ``pos`` (batch,) int32.  The
    paged layout is not ported yet (ROADMAP queue 1, item 5)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    topo = topology(cfg)
    if topo.kind == "xlstm":
        lead = {"mlstm": (topo.n_groups, topo.per_group),
                "slstm": (topo.n_groups,)}
        init = {"mlstm": xlstm.init_mlstm_state(cfg, batch, device=dev),
                "slstm": xlstm.init_slstm_state(cfg, batch, device=dev)}
        cache = {name: {k: a.expand(*lead[name], *a.shape).clone()
                        for k, a in st.items()}
                 for name, st in init.items()}
        cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        return cache
    c = L.init_attn_cache(cfg, batch, max_len, dev)
    stack = lambda a: a[None].repeat(cfg.n_layers, *([1] * a.ndim))
    return {"k": stack(c["k"]), "v": stack(c["v"]), "pos": c["pos"]}


def _batch_dim(head: str) -> int:
    """Batch dim of a cache leaf under top-level key ``head``: k/v (L, B,
    ...) -> 1; mlstm states (G, P, B, ...) -> 2; slstm states (G, B, ...)
    -> 1; pos -> 0."""
    return {"k": 1, "v": 1, "mlstm": 2, "slstm": 1}.get(head, 0)


def reset_slot(cfg: ModelConfig, cache, fresh, slot: int):
    """Reset batch slot ``slot`` of a decode cache to ``fresh`` (a cache
    from init_cache), IN PLACE, and return the cache."""
    for head, leaf in cache.items():
        idx = (slice(None),) * _batch_dim(head) + (slot,)
        pairs = ((leaf[k], fresh[head][k]) for k in leaf) \
            if isinstance(leaf, dict) else ((leaf, fresh[head]),)
        for a, f in pairs:
            a[idx] = f[idx]
    return cache


def _decode_xlstm(cfg: ModelConfig, params: Model, cache, x):
    """The xLSTM blocks of one decode step, each state updated in place."""
    ms, ss = cache["mlstm"], cache["slstm"]
    for g, (mblks, sblk) in enumerate(zip(params.mlstm, params.slstm)):
        for i, blk in enumerate(mblks):
            x, new = _mlstm_block(cfg, blk, x, {k: ms[k][g, i] for k in ms})
            for k in ms:
                ms[k][g, i] = new[k]
        x, new = _slstm_block(cfg, sblk, x, {k: ss[k][g] for k in ss})
        for k in ss:
            ss[k][g] = new[k]
    return x


def decode(cfg: ModelConfig, params: Model, cache, inputs: torch.Tensor, *,
           serve: bool = True, collect_metrics: bool = False,
           row_mask: torch.Tensor | None = None):
    """One decode step.  inputs: tokens (B, 1).  Returns (logits (B, V),
    cache), or (logits, cache, metrics) when ``collect_metrics`` — the
    layer-meaned ApproxFFN dispatch metrics (dense family; empty for the
    xLSTM family, which has no ApproxFFN).

    The cache is updated IN PLACE and returned with ``pos`` advanced (the
    reference donates its cache and returns an updated one).  Dense
    family: ``row_mask`` ((B,) bool) marks the ACTIVE slots: idle slots are
    excluded from the dispatch and its stats, and their ``pos`` holds;
    every slot's ``pos`` must be below the cache length (checked here; the
    reference would clamp the write).  xLSTM family, as in the reference:
    every slot's ``pos`` advances by 1 whatever ``row_mask``, and there is
    no cache end to check."""
    x = L.embed_fwd(cfg, params.embed, inputs)
    pos = cache["pos"]
    per_layer = []
    if topology(cfg).kind == "xlstm":
        x = _decode_xlstm(cfg, params, cache, x)
        cache["pos"] = pos + 1
    else:
        if serve and cfg.approx.enable and cfg.approx.route_scope != "layer":
            raise NotImplementedError(
                f"route_scope={cfg.approx.route_scope!r} is not ported yet; "
                "the port routes per layer (ROADMAP queue 1, item 5)")
        skv = cache["k"].shape[2]
        if int(pos.max()) >= skv:
            raise ValueError(f"decode past the cache end: pos "
                             f"{pos.tolist()} with max_len {skv}")
        positions = pos[:, None]
        for i, blk in enumerate(params.blocks):
            lc = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
            x, _, _, m = _dense_block(cfg, blk, x, positions, lc,
                                      serve=serve, row_mask=row_mask)
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
