"""Model assembly (counterpart of ``repro/models/model.py``):

  dense / audio / vlm : N x (attn + FFN)   (training and prefill forward,
                                           chunked prefill and decode over
                                           a dense or paged KV cache)
  moe                 : N x (attn + MoE-FFN)   (the MoE takes the FFN's
                                           place: no ApproxFFN, no tick
                                           router, no tick plan; with a
                                           sliding window the KV cache is
                                           a ring buffer)
  ssm (xLSTM)         : G x ((k-1) mLSTM + 1 sLSTM)   (k = ssm.slstm_every)
  hybrid (zamba2)     : G x (k Mamba2 + the SHARED attn/FFN block)  (k =
                        attn_every; one parameter set applied at every
                        group boundary, with a KV cache per group)

Blocks are held in ``nn.ModuleList``s and applied in Python loops where
the reference scans over stacked parameters.  ``Model``'s parameter names
are the reference's pytree keys with the stacked leaves split per layer
(``blocks.<i>.attn.wq``, ``mlstm.<g>.<p>.core.w_q``, ``slstm.<g>.ln.scale``,
``mamba.<g>.<p>.core.w_xz``; ``shared.*`` is not stacked), so
``convert.params_from_jax`` loads a JAX checkpoint leaf by leaf.
``forward(serve=False)`` is the training forward: the ApproxFFN's
co-training and the tick-router head's across-layer vote, with each block
recomputed in the backward under ``cfg.remat``; ``lm_loss`` is the train
step's loss.  Inputs are tokens (B, S), or embeddings (B, S, d) under
``input_mode="embeddings"``.

On a mesh (inside ``runtime/steps.serve_mesh_context``) ``decode`` and
``decode_chunk`` are one rank's part of an SPMD program: they take the
GLOBAL batch's inputs, run the layers on the rank's data shard of the
rows (layers.py: tensor-parallel over "model") against its shard of the
cache, and return the global logits and the global (all-reduced)
dispatch metrics, the same on every rank.  ``init_cache`` then builds the
rank's shard of the cache and ``reset_slot`` resets a global slot where
this rank holds it.  ``pos`` stays whole on every rank (the rules
replicate it).  Every family serves on a mesh: the MoE expert-parallel
(``models/moe._moe_fwd_manual``, its aux loss the data shards' mean on
every rank), the hybrid's Mamba2 blocks and the xLSTM's mLSTM and sLSTM
blocks tensor-parallel by heads (``models/mamba2.py``,
``models/xlstm.py``: each rank holds its rows' and heads' recurrent
state).  Inside ``runtime/steps.train_mesh_context``
``forward(serve=False)`` and ``lm_loss`` take the rank's rows and give
the global batch's losses and metrics on every rank; a microbatch below
the data axes trains with every row on every data rank and its
positions split over them (``activations.sequence_split``: RoPE at the
global positions, attention over the keys gathered along the sequence,
the MoE routed over the global token groups, a recurrence's state handed
from slice to slice, ``sharding/sequence.py``).  Fewer kv heads
than model ranks run with each rank's head_dim slice of every kv head in
its cache (``layers.kv_split``), experts that do not divide over
"model" with each expert's d_ff split (``moe.tp_in_expert``), fewer
xLSTM heads than model ranks with each head's columns split
(``xlstm.heads_below_model``).  A served batch that does not divide over
the data axes is whole on every data rank (``activations.whole_rows``):
its logits are not gathered, its stats and MoE routing are one device's,
and a dense or ring KV cache is split over the data axes by sequence
(context-parallel decode, ``layers.py``).  A mesh that does not divide
the widths a family splits is refused (``check_mesh_servable``,
``check_mesh_trainable``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models.approx_ffn import (ApproxFFN, approx_ffn_serve,
                                           approx_ffn_train, execute_plan,
                                           make_tick_plan)
from repro_torch.runtime.dispatch import plan_invoke_stats
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import (manual_dp_context, row_axes,
                                             sequence_shard, whole_rows,
                                             with_current_context)
from repro_torch.sharding.rules import cache_pspecs, param_pspecs


@dataclasses.dataclass(frozen=True)
class Topology:
    """How layers group into block stacks for a family."""

    kind: str            # "uniform" | "xlstm" | "hybrid"
    n_groups: int = 0
    per_group: int = 0   # inner homogeneous run length


def topology(cfg: ModelConfig) -> Topology:
    if cfg.family == "ssm":
        k = cfg.ssm.slstm_every
        assert cfg.n_layers % k == 0, (cfg.n_layers, k)
        return Topology("xlstm", cfg.n_layers // k, k - 1)
    if cfg.family == "hybrid":
        k = cfg.attn_every or 6
        assert cfg.n_layers % k == 0, (cfg.n_layers, k)
        return Topology("hybrid", cfg.n_layers // k, k)
    return Topology("uniform", cfg.n_layers, 1)


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, cfg.d_model, device)
        self.attn = L.Attention(cfg, device, gen)
        self.ln2 = L.Norm(cfg, cfg.d_model, device)
        if cfg.moe.n_experts:
            self.moe = moe.MoE(cfg, device, gen)
        elif cfg.approx.enable:
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


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln = L.Norm(cfg, cfg.d_model, device)
        self.core = mamba2.Mamba(cfg, device, gen)


class Model(nn.Module):
    """The LM's parameters.  Built without a generator the storage is
    uninitialized (for loading); ``init_model`` initializes it."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
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
        if topo.kind == "hybrid":
            # mamba.<g>.<p>: G groups of P Mamba2 blocks, then ONE shared
            # attention+FFN block applied after every group (Zamba2)
            self.mamba = nn.ModuleList(
                nn.ModuleList(MambaBlock(cfg, device, gen)
                              for _ in range(topo.per_group))
                for _ in range(topo.n_groups))
            self.shared = DenseBlock(dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, n_experts=0)),
                device, gen)
        else:
            self.blocks = nn.ModuleList(DenseBlock(cfg, device, gen)
                                        for _ in range(cfg.n_layers))
        if cfg.approx.enable and not cfg.moe.n_experts:
            # tick-router head (route_scope="tick"), carried so that
            # conversion of a reference checkpoint is total
            self.tick_router = L.param(
                (cfg.d_model, cfg.approx.n_live + 1), cfg.pdtype, device,
                gen, cfg.d_model ** -0.5)


def init_model(key, cfg: ModelConfig, *, device=None, mesh=None) -> Model:
    """Random parameters from ``key``, an int seed or a ``torch.Generator``
    on ``device`` (default: the GPU, which must exist); ``key=None`` leaves
    the storage uninitialized (no draw: the dry run's fake shards).  On
    ``mesh`` each parameter is this rank's block of the same draw under
    ``sharding/rules.param_pspecs`` (its spec kept as ``_pspec``), cut as
    soon as it is drawn, so the whole model never exists at once."""
    dev = resolve_device(device)
    gen = key if key is None or isinstance(key, torch.Generator) \
        else torch.Generator(device=dev).manual_seed(int(key))
    if mesh is None:
        return Model(cfg, dev, gen)
    made = []                       # the parameters in creation order

    def record(t):
        made.append(nn.Parameter(t, requires_grad=False))
        return made[-1]
    with L.param_hook(record):
        meta = Model(cfg, torch.device("meta"))
    specs, _ = param_pspecs(mesh, meta)
    names = {id(p): n for n, p in meta.named_parameters()}
    todo = iter([specs[names[id(p)]] for p in made])

    def shard(t):
        spec = next(todo)
        p = nn.Parameter(C.shard_tensor(mesh, t, spec), requires_grad=False)
        p._pspec = spec
        return p
    with L.param_hook(shard):
        model = Model(cfg, dev, gen)
    C.shard_params(mesh, model)    # the constants made outside ``param``
    for name, p in model.named_parameters():
        assert p._pspec == specs[name], (name, p._pspec, specs[name])
    return model


def _dense_block(cfg: ModelConfig, p: DenseBlock, x, positions, cache, *,
                 serve=False, row_mask=None, dispatch_plan=None, tier=None,
                 tier_margins=None, residency=None):
    """One transformer block.  Returns (x, new_cache, aux_loss, metrics).

    ``dispatch_plan`` (serve, ``route_scope="tick"``): the tick's plan,
    built above the layers; this block's ApproxFFN executes against it
    and reports no metrics of its own (the step reports the plan's).
    ``tier``/``tier_margins`` (serve, layer scope): per-slot QoS tiers of
    this block's own routing (a tick plan embeds them).  ``residency``
    (serve, library): the (n_resident,) library ids whose weight rows
    this block executes.  ``cfg.parallel_block``: the FFN runs beside the
    attention on the same ``ln1`` input, one residual (stablelm-2 style)."""
    xn = L.norm_fwd(cfg, p.ln1, x)
    h, new_cache = L.attention_fwd(cfg, p.attn, xn, positions, cache)
    if cfg.parallel_block:
        f, aux, metrics = _ffn_part(cfg, p, xn, serve, row_mask,
                                    dispatch_plan, tier, tier_margins,
                                    residency)
        return x + h + f, new_cache, aux, metrics
    x = x + h
    f, aux, metrics = _ffn_part(cfg, p, L.norm_fwd(cfg, p.ln2, x), serve,
                                row_mask, dispatch_plan, tier, tier_margins,
                                residency)
    return x + f, new_cache, aux, metrics


def _ffn_part(cfg: ModelConfig, p: DenseBlock, xn, serve, row_mask=None,
              dispatch_plan=None, tier=None, tier_margins=None,
              residency=None):
    if cfg.moe.n_experts:                # the MoE wins over the ApproxFFN
        y, aux = moe.moe_fwd(cfg, p.moe, xn)
        return y, aux, {}
    zero = torch.zeros((), dtype=torch.float32, device=xn.device)
    if not cfg.approx.enable:
        return L.ffn_fwd(cfg, p.ffn, xn), zero, {}
    if not serve:
        # train path: the per-token competitive labels go up as votes,
        # summed over the layers to supervise the tick-router head
        y, a = approx_ffn_train(cfg, p.approx, xn)
        return y, a["loss"], {"invocation": a["invocation"],
                              "router_acc": a["router_acc"],
                              "_label_votes": a["label_votes"]}
    if dispatch_plan is not None:
        return execute_plan(cfg, p.approx, xn, dispatch_plan,
                            residency), zero, {}
    y, a = approx_ffn_serve(cfg, p.approx, xn, row_mask=row_mask,
                            tier=tier, tier_margins=tier_margins,
                            residency=residency)
    return y, a["loss"], _dispatch_metrics(a["invoke_stats"])


def _dispatch_metrics(st) -> dict:
    """A serve-mode ApproxFFN's metrics from its ``InvokeStats``."""
    total = st["class_counts"].sum().clamp(min=1).float()
    zero = torch.zeros((), dtype=torch.float32,
                       device=st["invocation"].device)
    return {"invocation": st["invocation"], "router_acc": zero,
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


def _tick_plan(cfg: ModelConfig, params: Model, x, row_mask, serve: bool,
               tier=None, tier_margins=None, residency=None):
    """The tick's dispatch plan under ``route_scope="tick"``, else None
    (an MoE model routes in its MoE, never by a tick plan); an unknown
    scope raises instead of routing per layer."""
    if not (serve and cfg.approx.enable):
        return None
    if cfg.approx.route_scope not in ("layer", "tick"):
        raise ValueError(f"unknown route_scope: {cfg.approx.route_scope!r} "
                         "(expected 'layer' or 'tick')")
    if cfg.approx.route_scope == "layer" or cfg.moe.n_experts:
        return None
    return make_tick_plan(cfg, params, x, row_mask, tier=tier,
                          tier_margins=tier_margins, residency=residency)


def _step_metrics(plan, per_layer: list) -> dict:
    """A step's metrics: the tick plan's stats (every layer executed that
    one plan; the reference means L equal copies), else the layer mean."""
    if plan is not None:
        return _dispatch_metrics(plan_invoke_stats(plan))
    if not per_layer or not per_layer[0]:
        return {}
    return {k: torch.stack([m[k] for m in per_layer]).mean(0)
            for k in per_layer[0]}


def _layer_cache(cache, i: int, pos=None, **extra) -> dict:
    """Layer ``i``'s view of a stacked dense or paged KV cache (the one
    block table serves every layer); ``pos`` overrides the cache's (a
    mesh rank's rows)."""
    lc = {"k": cache["k"][i], "v": cache["v"][i],
          "pos": cache["pos"] if pos is None else pos, **extra}
    if "block_table" in cache:
        lc["block_table"] = cache["block_table"]
    return lc


# ---- xLSTM ---------------------------------------------------------------

def _mlstm_block(cfg: ModelConfig, p: MLSTMBlock, x, state):
    y, st = xlstm.mlstm_fwd(cfg, p.core, L.norm_fwd(cfg, p.ln, x), state)
    return x + y, st


def _slstm_block(cfg: ModelConfig, p: SLSTMBlock, x, state):
    y, st = xlstm.slstm_fwd(cfg, p.core, L.norm_fwd(cfg, p.ln, x), state)
    return x + y, st


def _mamba_block(cfg: ModelConfig, p: MambaBlock, x, state):
    y, st = mamba2.mamba_fwd(cfg, p.core, L.norm_fwd(cfg, p.ln, x), state)
    return x + y, st


def _maybe_remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``cfg.remat`` when
    autograd records (the reference's ``jax.checkpoint`` of the block
    body): the same values, fewer activations kept.  The recompute runs
    in the mesh context of the forward (``with_current_context``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(with_current_context(fn), *args,
                          use_reentrant=False)
    return fn(*args)


def _tick_router_loss(cfg: ModelConfig, params: Model, x0, votes):
    """The tick-router head's co-training: the label of each token is the
    argmax of its competitive-label votes summed over the layers (the
    first maximum on a tie), the head classifies the pre-layer hidden
    state ``x0``.  Returns (loss, accuracy)."""
    tick_labels = votes.argmax(-1)
    t_logits = (x0.reshape(votes.shape[0], -1)
                @ params.tick_router.to(x0.dtype)).float()
    logp = F.log_softmax(t_logits, -1)
    loss = -logp.gather(1, tick_labels[:, None]).mean()
    acc = (t_logits.argmax(-1) == tick_labels).float().mean()
    return _global_means(loss, acc)


def _global_means(*means):
    """Means over this rank's rows as the global batch's: on a mesh (a
    train mesh context) the mean of the data shards' means (equal
    shards), the same on every rank; else as they are."""
    mesh, dp = manual_dp_context()
    if mesh is None:
        return means
    g = mesh.size(dp)
    return tuple(m / g for m in C.all_reduce_sum(torch.stack(means),
                                                  dp).unbind())


def forward(cfg: ModelConfig, params: Model, inputs: torch.Tensor, *,
            collect_cache: bool = False, serve: bool = False):
    """Full-sequence forward.  inputs: tokens (B, S), or embeddings (B,
    S, d) under ``input_mode="embeddings"``.

    Returns (logits (B, S, V), cache-or-None, aux_loss, metrics).  With
    ``collect_cache`` the cache is the decode cache after S tokens, laid
    out as init_cache lays it out with max_len S (dense family: the
    post-RoPE K/V of every layer, or with a sliding window the ring
    buffer of the last min(S, window) positions, which needs S to be a
    multiple of it; xLSTM: every block's final state;
    hybrid: every Mamba2 block's final state and the shared block's K/V
    of every group), and ``pos = S``; ``pad_cache`` grows the K/V to
    decode room.  Dense and hybrid families: ``serve=True`` runs each
    ApproxFFN application through the capacity dispatch, routing its own
    tokens (the reference builds no tick plan here), with the dispatch
    metrics meaned over the layers (hybrid: over the groups).

    ``serve=False`` is the training forward.  Each ApproxFFN runs its
    co-training path (the exact FFN's output, the router and distillation
    losses summed into ``aux_loss``, ``invocation`` and ``router_acc``
    meaned over the layers), and the tick-router head trains on the
    across-layer vote of the competitive labels, adding
    ``router_weight`` x its cross-entropy to ``aux_loss`` with metrics
    ``tick_router_loss`` and ``tick_router_acc``.  Under ``cfg.remat``
    each block is recomputed in the backward.  ``serve`` changes nothing
    for the xLSTM family (it has no ApproxFFN)."""
    x = L.embed_fwd(cfg, params.embed, inputs)
    b, s = x.shape[0], x.shape[1]
    metrics, cache = {}, None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    topo = topology(cfg)
    pos_s = torch.full((b,), s, dtype=torch.int32, device=x.device)
    if topo.kind in ("uniform", "hybrid"):
        shard = sequence_shard(s)        # a rank's slice of the positions
        positions = torch.arange(s, device=x.device)[None, :] \
            + (0 if shard is None else shard.start)
        x0, votes = x, None
        per_layer, auxs, ks, vs, mstates = [], [], [], [], []

        def block(blk, x):
            x, kv, aux, m = _dense_block(cfg, blk, x, positions, None,
                                         serve=serve)
            return x, (kv["k"], kv["v"]) if collect_cache else (), aux, m
        # uniform: each layer's own block; hybrid: each group's Mamba2
        # run, then the one shared block
        groups = [((), blk) for blk in params.blocks] \
            if topo.kind == "uniform" \
            else [(mblks, params.shared) for mblks in params.mamba]
        for mblks, blk in groups:
            msts = []
            for mblk in mblks:
                x, st = _maybe_remat(cfg, _mamba_block, cfg, mblk, x, None)
                msts.append(st["h"])
            x, kv, aux, m = _maybe_remat(cfg, block, blk, x)
            if "_label_votes" in m:
                v = m.pop("_label_votes")
                votes = v if votes is None else votes + v
            per_layer.append(m)
            auxs.append(aux)
            if collect_cache:
                ks.append(kv[0])
                vs.append(kv[1])
                mstates.append(msts)
        metrics = _step_metrics(None, per_layer)
        aux_total = torch.stack(auxs).sum()
        if votes is not None:           # the train path's label votes
            tick_loss, tick_acc = _tick_router_loss(cfg, params, x0, votes)
            aux_total = aux_total + cfg.approx.router_weight * tick_loss
            metrics = dict(metrics, tick_router_loss=tick_loss,
                           tick_router_acc=tick_acc)
        if collect_cache:
            ks, vs = torch.stack(ks), torch.stack(vs)
            if cfg.sliding_window:
                # the ring buffer after S tokens: the last w positions,
                # position p at row p % w
                w = min(s, cfg.sliding_window)
                assert s % w == 0, \
                    "ring-buffer alignment needs S % window == 0"
                ks = ks[:, :, -w:].contiguous()
                vs = vs[:, :, -w:].contiguous()
            cache = {"k": ks, "v": vs, "pos": pos_s}
            if topo.kind == "hybrid":
                cache["mamba"] = {"h": torch.stack([torch.stack(g)
                                                    for g in mstates])}
    else:
        mstates, sstates = [], []
        for mblks, sblk in zip(params.mlstm, params.slstm):
            msts = []
            for blk in mblks:
                x, st = _maybe_remat(cfg, _mlstm_block, cfg, blk, x, None)
                msts.append(st)
            x, sst = _maybe_remat(cfg, _slstm_block, cfg, sblk, x, None)
            if collect_cache:
                mstates.append(msts)
                sstates.append(sst)
        if collect_cache:
            cache = {"mlstm": {k: torch.stack([torch.stack([st[k]
                                                            for st in g])
                                               for g in mstates])
                               for k in ("c", "n")},
                     "slstm": {k: torch.stack([st[k] for st in sstates])
                               for k in ("h", "c", "n", "m")},
                     "pos": pos_s}
    x = L.norm_fwd(cfg, params.ln_f, x)
    logits = L.unembed_fwd(cfg, params.embed, x)
    return logits, cache, aux_total, metrics


def lm_loss(cfg: ModelConfig, params: Model, inputs: torch.Tensor,
            labels: torch.Tensor):
    """Next-token cross-entropy (+ the family's aux losses) of the
    training forward.  labels: (B, S).  Returns (loss + aux, metrics with
    ``lm_loss`` and ``aux_loss``).  The max is subtracted without a
    gradient, and the label's logit is gathered where the reference
    contracts with a one-hot (the same value).

    On a mesh (``runtime/steps.train_mesh_context``) ``inputs`` and
    ``labels`` are the rank's rows, and the loss is the global batch's
    mean, the same on every rank (``check_mesh_trainable`` says which
    configs and meshes train there)."""
    logits, _, aux, metrics = forward(cfg, params, inputs)
    logits = logits.float()
    shifted = logits - logits.amax(-1, keepdim=True).detach()
    lse = torch.logsumexp(shifted, -1)
    picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
    (loss,) = _global_means((lse - picked).mean())
    return loss + aux, dict(metrics, lm_loss=loss, aux_loss=aux)


# ---------------------------------------------------------------------------
# Decode (single token, cache update)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               page_size: int = 0, kv_pages: int = 0, device=None):
    """Empty decode cache.  Dense family: k/v (L, batch, max_len, Kh, hd),
    or with ``page_size > 0`` the PAGED layout: per-layer pools (L,
    kv_pages + 1, page_size, Kh, hd), whose last page is the trash page
    of ``layers.init_attn_cache`` (the reference's pools stop at
    kv_pages), plus ONE ``block_table`` (batch, max_len // page_size)
    shared by every layer.  xLSTM: the mLSTM states (G, P, batch, ...)
    and the sLSTM states (G, batch, ...), whatever ``max_len``.  Hybrid:
    the Mamba2 states ``mamba.h`` (G, P, batch, H, P_hd, N) and the shared
    block's k/v of every group (G, batch, max_len, Kh, hd).  All with
    ``pos`` (batch,) int32.  A sliding-window config's k/v are ring
    buffers of min(max_len, window) rows, and take no paged layout."""
    dev = resolve_device(device)
    topo = topology(cfg)
    if page_size:
        assert topo.kind == "uniform" and not cfg.sliding_window, (
            "paged KV caches need the uniform dense-attention family "
            f"(got family={cfg.family!r}, "
            f"sliding_window={cfg.sliding_window})")
    if topo.kind == "xlstm":
        lead = {"mlstm": (topo.n_groups, topo.per_group),
                "slstm": (topo.n_groups,)}
        init = {"mlstm": xlstm.init_mlstm_state(cfg, batch, device=dev),
                "slstm": xlstm.init_slstm_state(cfg, batch, device=dev)}
        cache = {name: {k: a.expand(*lead[name], *a.shape).clone()
                        for k, a in st.items()}
                 for name, st in init.items()}
        cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    else:
        cache = L.init_attn_cache(cfg, batch, max_len, dev,
                                  page_size=page_size, n_pages=kv_pages)
        n = cfg.n_layers if topo.kind == "uniform" else topo.n_groups
        for k in ("k", "v"):
            cache[k] = cache[k][None].repeat(n, *([1] * cache[k].ndim))
        if topo.kind == "hybrid":
            h = mamba2.init_mamba_state(cfg, batch, dev)["h"]
            cache["mamba"] = {"h": h.expand(topo.n_groups, topo.per_group,
                                            *h.shape).clone()}
    mesh, _ = manual_dp_context()
    return cache if mesh is None else shard_cache(mesh, cache)


def shard_cache(mesh, cache: dict) -> dict:
    """This rank's shard of a cache, as ``sharding/rules.cache_pspecs``
    places it (rows over data, kv heads over model, or head_dim where the
    kv heads are fewer than the model ranks; ``pos`` and a paged pool's
    pages whole).  Rows that do not divide over the data axes are whole,
    and a dense or ring k/v then split over them by sequence; one whose
    length does not divide either is refused (the rules would replicate
    it, the port's attention splits it)."""
    specs = cache_pspecs(mesh, cache)
    if "k" in cache and "block_table" not in cache:
        _check_cache_rows(mesh, *cache["k"].shape[1:3])

    def walk(tree, specs):
        return {k: walk(v, specs[k]) if isinstance(v, dict)
                else C.shard_tensor(mesh, v, specs[k])
                for k, v in tree.items()}
    return walk(cache, specs)


def _mesh_sizes(mesh):
    """({axis: size}, |model|, the data axes' size)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    g = 1
    for ax in ("pod", "data"):
        g *= sizes.get(ax, 1)
    return sizes, sizes.get("model", 1), g


def _model_widths(cfg: ModelConfig, train: bool, md: int) -> dict:
    """{what: width} of the widths the tensor-parallel branches split over
    "model": the attention heads, the kv heads (where ranks share a kv
    head, ``layers.kv_split``: head_dim), d_ff (an MoE: its experts, else
    each expert's d_ff, ``moe.tp_in_expert``) and the Mamba2 heads and
    B/C columns (the hybrid); the xLSTM's heads (where |model| ranks share
    each head, ``xlstm.heads_below_model``: d_qk, d_in and 4d) and its
    sLSTM's d_up; the vocab too in training."""
    kind = topology(cfg).kind
    if kind == "xlstm" and xlstm.heads_below_model(cfg, md):
        d, d_in, d_qk = xlstm.mlstm_dims(cfg)[:3]
        widths = {f"d_qk (heads={cfg.n_heads} below model)": d_qk,
                  "d_in": d_in, "4d": 4 * d, "d_up": xlstm.slstm_d_up(cfg)}
    elif kind == "xlstm":
        widths = {"heads": cfg.n_heads, "d_up": xlstm.slstm_d_up(cfg)}
    else:
        widths = {"heads": cfg.n_heads}
        kv = cfg.n_kv_heads
        if L.kv_split(cfg, md):
            widths[f"head_dim (kv heads={kv} below model)"] = cfg.hd
        else:
            widths["kv heads"] = kv
        e = cfg.moe.n_experts
        if moe.tp_in_expert(cfg, md):
            widths[f"d_ff (experts={e}, TP-in-expert)"] = cfg.d_ff
        elif e:
            widths["experts"] = e
        else:
            widths["d_ff"] = cfg.d_ff
        if kind == "hybrid":
            widths["Mamba2 heads"] = mamba2.mamba_dims(cfg)[1]
            widths["B/C columns"] = 2 * cfg.ssm.d_state
    if train:
        widths["vocab"] = cfg.vocab
    return widths


def _check_widths(cfg: ModelConfig, mesh, batch: int, train: bool,
                  seq: int = 0):
    """Raise unless every width of ``_model_widths`` divides over "model"
    and, in training, a microbatch of ``batch`` rows of ``seq`` positions
    trains over the data axes: its rows divide over them, or its
    positions do and each family's blocking is well defined on a rank's
    slice of them (``_seq_split_fits``).  A served batch need not divide:
    below the data axes its rows are whole on every data rank
    (``activations.whole_rows``)."""
    sizes, md, g = _mesh_sizes(mesh)
    widths = _model_widths(cfg, train, md)
    rows_ok = not train or batch % g == 0 or _seq_split_fits(cfg, g, seq)
    if "model" in sizes and rows_ok \
            and not any(n % md for n in widths.values()):
        return
    what = ("the sharded train path", "microbatch") if train \
        else ("the sharded serve path", "batch")
    rows = "" if not train else \
        "the microbatch over the data axes; " if rows_ok else \
        (f"the microbatch over the data axes, or below them its "
         f"{seq or 'unstated'} positions over them with "
         f"{_seq_blocking(cfg)} within a rank's slice; ")
    raise NotImplementedError(
        f"mesh {dict(sizes)} does not divide {what[0]} of {cfg.name} at "
        f"{what[1]} {batch} ({rows}"
        + ", ".join(f"{k}={n}" for k, n in widths.items())
        + " over model): the reference falls back to compiler-placed "
        "sharding there, the port refuses (ROADMAP queue 3, layout "
        "departures)")


def _seq_blocks(cfg: ModelConfig) -> dict:
    """{name: block} of the blocks a rank's slice of the positions runs
    in: attention's query blocks (the dense, MoE and hybrid families),
    the SSD's chunks (the hybrid) and the mLSTM's (the xLSTM)."""
    kind = topology(cfg).kind
    blocks = {} if kind == "xlstm" else {"q_block": cfg.q_block}
    if kind != "uniform":
        blocks["ssm.chunk"] = cfg.ssm.chunk
    return blocks


def _seq_blocking(cfg: ModelConfig) -> str:
    return " and ".join(f"{k}={n}" for k, n in _seq_blocks(cfg).items()) \
        or "no blocking"


def _seq_split_fits(cfg: ModelConfig, g: int, seq: int) -> bool:
    """Whether a microbatch below ``g`` data ranks trains split by
    sequence over them (``activations.sequence_split``): ``seq`` divides
    over them, and each block of ``_seq_blocks`` divides a rank's slice
    or clips to it (the keys stay whole: attention gathers them)."""
    if not seq or seq % g:
        return False
    n = seq // g
    return all(n % min(blk, n) == 0 for blk in _seq_blocks(cfg).values())


def _check_cache_rows(mesh, batch: int, rows: int):
    """Raise where a dense or ring KV cache of ``rows`` rows a slot can
    be split neither by its ``batch`` slots nor by sequence over the data
    axes (the rules would replicate it; the port's attention splits it)."""
    _, _, g = _mesh_sizes(mesh)
    if g == 1 or batch % g == 0 or rows % g == 0:
        return
    raise NotImplementedError(
        f"a KV cache of {rows} rows for a batch of {batch} over {g} data "
        "ranks: a batch below the data axes needs the cache length to "
        "divide over them (context-parallel decode); the reference "
        "replicates such a cache, the port refuses (ROADMAP queue 3, "
        "layout departures)")


def check_mesh_servable(cfg: ModelConfig, mesh, batch: int, *,
                        max_len: int = 0, paged: bool = False):
    """Raise unless ``cfg`` serves on ``mesh`` at ``batch`` slots: over
    "model" the attention heads, the kv heads (or, with fewer kv heads
    than ranks and |model| a multiple of them, head_dim:
    ``layers.kv_split``) and d_ff (the sharded
    serve path's predicate, ``approx_ffn._manual_serve_ctx``; an MoE: its
    experts, or each expert's d_ff: ``moe.tp_in_expert``), the hybrid's
    Mamba2 heads and B/C columns, the xLSTM's heads (or, with |model| a
    multiple of them, d_qk, d_in and 4d: ``xlstm.heads_below_model``) and
    d_up.  A batch that does not divide over the data axes is served
    whole on every data rank, a dense or ring KV cache then split over
    them by sequence (context-parallel, ``layers.py``): given ``max_len``
    that cache's rows (a ring's: the window) must divide over the data
    axes then, unless it is ``paged`` (a pool, whole on every data rank).
    Where it fails the reference falls back to compiler-placed sharding;
    the port has no such fallback (ROADMAP queue 3)."""
    _check_widths(cfg, mesh, batch, train=False)
    if max_len and not paged and topology(cfg).kind != "xlstm":
        w = cfg.sliding_window
        _check_cache_rows(mesh, batch, min(max_len, w) if w else max_len)


def check_mesh_trainable(cfg: ModelConfig, mesh, batch: int,
                         seq: int = 0):
    """Raise unless ``cfg`` trains on ``mesh`` with microbatches of
    ``batch`` rows of ``seq`` positions: ``check_mesh_servable``'s widths
    and the vocab over "model", and the microbatch over the data axes
    (every tensor-, expert- and head-parallel branch of the train path
    engaged) or, below them, its positions split over them
    (``activations.sequence_split``: every row on every data rank, the
    sequence divided, attention's query blocks and the SSD's and mLSTM's
    chunks dividing a rank's slice or clipped to it).  Where it fails
    the reference falls back to compiler-placed sharding; the port
    refuses (ROADMAP queue 3)."""
    _check_widths(cfg, mesh, batch, train=True, seq=seq)


def _local(rows, *tensors):
    """Each tensor's ``rows`` (None stays None)."""
    return tuple(None if t is None else t[rows] for t in tensors)


@contextlib.contextmanager
def _mesh_rows(cfg: ModelConfig, b: int):
    """(mesh, dp, this rank's rows of a ``b``-row batch) inside a serve
    mesh context, else (None, (), every row).  A batch that does not
    divide over the data axes is whole on every data rank: the block runs
    under ``activations.whole_rows`` (the rows replicated, a dense or ring
    KV cache split by sequence)."""
    mesh, dp = manual_dp_context()
    if mesh is None:
        yield None, (), slice(None)
        return
    check_mesh_servable(cfg, mesh, b)
    with whole_rows(b % mesh.size(dp) != 0):
        yield mesh, dp, C.local_rows(mesh, dp, b)


def _batch_dim(head: str, paged: bool = False):
    """Batch dim of a cache leaf under top-level key ``head``: k/v (L or
    G, B, ...) -> 1, or None for a paged cache's shared pools; mlstm and
    mamba states (G, P, B, ...) -> 2; slstm states (G, B, ...) -> 1; pos,
    block_table -> 0."""
    if head in ("k", "v"):
        return None if paged else 1
    return {"mlstm": 2, "mamba": 2, "slstm": 1}.get(head, 0)


def reset_slot(cfg: ModelConfig, cache, fresh, slot: int):
    """Reset batch slot ``slot`` of a decode cache to ``fresh`` (a cache
    from init_cache), IN PLACE, and return the cache.  Paged caches: the
    pools are shared by every slot (freeing pages is the server
    allocator's job), so only the slot's block-table row (back to -1)
    and ``pos`` (back to 0) reset.  On a mesh ``slot`` is a global slot:
    the whole ``pos`` resets it on every rank, a row-sharded leaf only on
    the data shard that holds it (at its local row)."""
    paged = "block_table" in cache
    mesh, dp = manual_dp_context()
    batch = cache["pos"].shape[0]
    for head, leaf in cache.items():
        d = _batch_dim(head, paged)
        if d is None:
            continue
        pairs = ((leaf[k], fresh[head][k]) for k in leaf) \
            if isinstance(leaf, dict) else ((leaf, fresh[head]),)
        for a, f in pairs:
            i = slot
            if mesh is not None and a.shape[d] != batch:
                rows = C.local_rows(mesh, dp, batch)
                if not rows.start <= slot < rows.stop:
                    continue                  # another data shard's slot
                i = slot - rows.start
            idx = (slice(None),) * d + (i,)
            a[idx] = f[idx]
    return cache


def pad_cache(cfg: ModelConfig, cache, max_len: int):
    """Grow a prefill-built cache's KV length (axis 2 of the dense and
    the hybrid family's k/v) to ``max_len`` (decode room), zero-filled.
    No-op for an xLSTM cache, a ring buffer (its length is the window)
    and a paged cache (a fixed pool: its capacity is kv_pages, not a
    per-slot length)."""
    if "k" not in cache or cfg.sliding_window or "block_table" in cache:
        return cache
    pad = max_len - cache["k"].shape[2]
    if pad <= 0:
        return cache
    grow = lambda a: torch.cat([a, a.new_zeros(
        (a.shape[0], a.shape[1], pad, *a.shape[3:]))], 2)
    return dict(cache, k=grow(cache["k"]), v=grow(cache["v"]))


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
           row_mask: torch.Tensor | None = None,
           tier: torch.Tensor | None = None,
           tier_margins: torch.Tensor | None = None,
           residency: torch.Tensor | None = None):
    """One decode step.  inputs: tokens (B, 1), or embeddings (B, 1, d)
    under ``input_mode="embeddings"``.  Returns (logits (B, V), cache), or
    (logits, cache, metrics) when ``collect_metrics`` — the ApproxFFN
    dispatch metrics (dense family: the layer mean; hybrid: the mean over
    the shared block's applications; under ``route_scope="tick"`` the one
    tick plan's stats; empty for the xLSTM family, which has no
    ApproxFFN).

    The cache is updated IN PLACE and returned with ``pos`` advanced (the
    reference donates its cache and returns an updated one).  Dense
    family, dense or paged cache: ``row_mask`` ((B,) bool) marks the
    ACTIVE slots: idle slots are excluded from the dispatch and its
    stats, and their ``pos`` holds.  A slot at or past the cache end
    decodes as in the reference (``layers.attention_fwd`` clamps its
    write; a sliding window's ring buffer wraps instead); nothing here
    reads ``pos`` on the host.  An MoE model routes in each block's MoE
    (no tick plan) and reports no metrics; its idle slots' rows still
    compete for expert capacity, as in the reference.
    ``route_scope="tick"`` builds one DispatchPlan from the tick-router
    head above the layers and every layer executes against it.

    ``tier`` ((B,) int32) and ``tier_margins`` ((n_tiers,) float32):
    per-slot QoS tiers, each slot routed at its own tier's exact-logit
    margin, and the metrics carry the per-tier split.  ``residency``
    ((n_resident,) int32 library ids, ``approx.library_size > 0``):
    routing covers the full library, folds onto the resident slots, and
    every layer executes the residency-gathered weight rows.  Both are
    tensor data: a new tier mix, margin or hot set needs no new step.

    xLSTM family, as in the reference: every slot's ``pos`` advances by
    1 whatever ``row_mask``, and there is no cache end.

    Hybrid family, as in the reference: one tick plan (tick scope) serves
    every application of the shared block, whose k/v are those of the
    group (``cache["k"][g]``); ``row_mask`` excludes idle slots from the
    dispatch, but every slot's ``pos`` advances by 1 and every slot's
    Mamba2 state steps (a recycled slot is reset on admission).

    On a mesh: the rank's rows of the inputs, the mask and the tiers run
    through the layers, and the logits come back all-gathered; a batch
    below the data axes runs whole on every rank (module docstring)."""
    pos_all, row_mask_all = cache["pos"], row_mask
    with _mesh_rows(cfg, inputs.shape[0]) as (mesh, dp, rows):
        inputs, row_mask, tier = _local(rows, inputs, row_mask, tier)
        x = L.embed_fwd(cfg, params.embed, inputs)
        pos = pos_all[rows]
        per_layer, plan = [], None
        kind = topology(cfg).kind
        if kind == "xlstm":
            x = _decode_xlstm(cfg, params, cache, x)
            cache["pos"] = pos_all + 1
        else:
            plan = _tick_plan(cfg, params, x, row_mask, serve, tier,
                              tier_margins, residency)
            if plan is not None:
                tier = tier_margins = None       # the plan embeds the tiers
            positions = pos[:, None]
            if kind == "uniform":
                groups = [((), blk) for blk in params.blocks]
            else:
                groups = [(mblks, params.shared) for mblks in params.mamba]
                mh = cache["mamba"]["h"]
            for i, (mblks, blk) in enumerate(groups):
                for j, mblk in enumerate(mblks):
                    x, new = _mamba_block(cfg, mblk, x, {"h": mh[i, j]})
                    mh[i, j] = new["h"]
                x, _, _, m = _dense_block(cfg, blk, x, positions,
                                          _layer_cache(cache, i, pos),
                                          serve=serve, row_mask=row_mask,
                                          dispatch_plan=plan, tier=tier,
                                          tier_margins=tier_margins,
                                          residency=residency)
                per_layer.append(m)
            adv = 1 if row_mask_all is None or kind == "hybrid" \
                else row_mask_all.to(torch.int32)
            cache["pos"] = (pos_all + adv).to(torch.int32)
        x = L.norm_fwd(cfg, params.ln_f, x)
        logits = L.unembed_fwd(cfg, params.embed, x)[:, 0]
        if row_axes():
            logits = C.all_gather(logits, dp, 0)
        if not collect_metrics:
            return logits, cache
        return logits, cache, _step_metrics(plan, per_layer)


def decode_chunk(cfg: ModelConfig, params: Model, cache,
                 tokens: torch.Tensor, n_valid: torch.Tensor, *,
                 serve: bool = True, collect_metrics: bool = False,
                 row_mask: torch.Tensor | None = None,
                 tier: torch.Tensor | None = None,
                 tier_margins: torch.Tensor | None = None,
                 residency: torch.Tensor | None = None):
    """One chunked-PREFILL step against the decode cache layout (dense or
    paged).

    tokens: (B, S) int32, up to S prompt tokens per slot, appended at each
    slot's own offset ``cache["pos"]``; ``n_valid`` (B,) int32 counts the
    real tokens per slot (0 = the slot sits this step out; the tail of
    its row is padding).  Returns ``(cache, metrics)``, the cache updated
    IN PLACE with ``pos`` advanced by ``n_valid``.  No logits: the final
    prompt token goes through the decode step.  Writes at or past the
    cache end, and padded tokens, write nothing.  The serve-mode dispatch
    (and the tick plan) runs on the B*S rows under a TOKEN mask (the slot
    is active and the token is below its ``n_valid``), so padded rows
    never reach the router, the capacities or a stat.  ``tier``,
    ``tier_margins`` and ``residency`` as in ``decode`` (a slot's tier
    holds for all its S tokens)."""
    topo = topology(cfg)
    assert topo.kind == "uniform" and not cfg.sliding_window, \
        "decode_chunk needs the uniform family with a dense KV cache " \
        f"(got family={cfg.family!r}, sliding_window={cfg.sliding_window})"
    s = tokens.shape[1]
    n_valid_all = n_valid.to(torch.int32)
    with _mesh_rows(cfg, tokens.shape[0]) as (_, _, rows):
        tokens, row_mask, tier = _local(rows, tokens, row_mask, tier)
        x = L.embed_fwd(cfg, params.embed, tokens)
        pos = cache["pos"][rows]
        off = torch.arange(s, device=x.device)
        positions = pos[:, None] + off[None, :]                    # (B, S)
        n_valid = n_valid_all[rows]
        tok_mask = off[None, :] < n_valid[:, None]
        if row_mask is not None:
            tok_mask = tok_mask & row_mask.to(torch.bool)[:, None]
        plan = _tick_plan(cfg, params, x, tok_mask, serve, tier, tier_margins,
                          residency)
        if plan is not None:
            tier = tier_margins = None           # the plan embeds the tiers
        per_layer = []
        for i, blk in enumerate(params.blocks):
            x, _, _, m = _dense_block(cfg, blk, x, positions,
                                      _layer_cache(cache, i, pos,
                                                   n_valid=n_valid),
                                      serve=serve, row_mask=tok_mask,
                                      dispatch_plan=plan, tier=tier,
                                      tier_margins=tier_margins,
                                      residency=residency)
            per_layer.append(m)
        cache["pos"] = (cache["pos"] + n_valid_all).to(torch.int32)
        metrics = _step_metrics(plan, per_layer) if collect_metrics else {}
        return cache, metrics
