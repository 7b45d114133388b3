"""Shared LM layers (counterpart of ``repro/models/layers.py``): the norms,
RoPE (partial rotary included), embeddings (tied or not, token or
embedding inputs), the FFN (gated or not, four activations) and GQA
attention (with or without qkv biases, full or sliding-window): blockwise
flash attention over a full sequence, chunked prefill and single-step
decode over a dense or paged KV cache, or over a sliding window's ring
buffer.

Parameters live in small ``nn.Module`` containers whose attribute names
are the reference's parameter keys, in the reference's layouts (matrices
``(in, out)``), so converted JAX weights load leaf by leaf.  Their
constructors take the place of the reference's ``init_*`` functions: built
without a generator a container holds uninitialized storage for loading;
with one it is initialized like the reference (random normal scaled by
fan-in, norms to one).  The ``*_fwd`` functions apply them.

Attention is plain PyTorch, as it is plain JAX in the reference: the
same einsums, the f32 scores, the ``-1e30`` mask and the softmax weights
cast to the value dtype.

On a mesh (inside ``runtime/steps.serve_mesh_context`` or
``train_mesh_context``, one process per rank) each rank holds its block of every weight as
``sharding/rules.param_pspecs`` places it, and its data shard's rows of
the activations, replicated over "model".  The layers then run
tensor-parallel over "model" where the rules shard: attention
head-parallel (``wq``/``wk``/``wv`` column-parallel, each rank's head
counts read off its local widths, GQA's contiguous split keeping q head
``h`` with kv head ``h // rep``; ``wo`` row-parallel and one all-reduce),
the FFN as Megatron column and row (one all-reduce), the token table
vocab-parallel (a masked local lookup and one all-reduce) and the output
projection vocab-parallel (the logits all-gathered over "model").  The
weights' data-sharded dims are all-gathered at use (FSDP
unshard-on-use, ``sharding/collectives.unshard``).  The KV cache holds
this rank's rows and kv heads (with fewer kv heads than model ranks:
head_dim / |model| dims of every kv head, ``_attention_split``); a paged
pool is whole on every data shard
(the rules replicate pages over data) and needs no traffic between
shards: each slot's block-table row routes its reads to its own pages,
so a page that another shard's slot writes is never read here, and each
data rank writes only its own slots' pages.  A served batch below the
data axes (``activations.whole_rows``) is whole on every data rank, and
its dense or ring cache is split over them by sequence
(context-parallel): a rank writes a token only where its row falls in
the rank's slice (masked on the device), attends over its slice keeping
the softmax's max, sum and weighted values in f32, and the parts combine
over the data axes by log-sum-exp in rank order (``_combine_over_data``),
so every data rank holds the same bits; a paged pool stays whole and
each data rank attends as one device.  Training runs full causal
attention over the rank's rows; a microbatch below the data axes
(``activations.sequence_split``) holds every row and a slice of the
positions on each data rank, which attends with its queries over the
keys and values gathered along the sequence (``_self_attention``).  The
collectives carry their backward
(``sharding/collectives.py``): an all-reduced output's gradient passes
as it is, a replicated input of a column-parallel projection gets its
gradient summed over "model" (``copy_to_model``), the gathered logits
give each rank its vocab block's gradient, and an unsharded weight's
gradient is reduce-scattered over the data axes.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from contextlib import contextmanager
from contextvars import ContextVar

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import (SeqShard, context_parallel,
                                             manual_dp_context,
                                             sequence_shard)
from repro_torch.sharding.sequence import gather_sequence


# what ``param`` makes of each tensor it draws, while ``param_hook`` is on
_PARAM_HOOK: ContextVar = ContextVar("param_hook", default=None)


@contextmanager
def param_hook(fn):
    """Every ``param`` made inside is ``fn(tensor)`` (an ``nn.Parameter``)
    instead of the tensor as drawn: ``model.init_model(mesh=)`` records
    the creation order with it, then cuts each tensor to a rank's block as
    soon as it is drawn."""
    tok = _PARAM_HOOK.set(fn)
    try:
        yield
    finally:
        _PARAM_HOOK.reset(tok)


def draw(shape, dtype, device, gen, scale) -> torch.Tensor:
    """normal(0, 1) * ``scale`` from ``gen``, drawn in float32 and cast to
    ``dtype`` (a parameter's draw, or a block of one)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(scale).to(dtype)


def param(shape, dtype, device, gen=None, scale=None, fill=None):
    """A frozen parameter (training turns ``requires_grad`` on: runtime/
    steps.init_train_state): ``fill`` everywhere, normal(0, 1) * ``scale``
    from ``gen``, or uninitialized storage when neither is given; inside
    ``param_hook`` what its function makes of that tensor."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    elif gen is not None:
        t = draw(shape, dtype, device, gen, scale)
    else:
        t = torch.empty(shape, dtype=dtype, device=device)
    hook = _PARAM_HOOK.get()
    return nn.Parameter(t, requires_grad=False) if hook is None else hook(t)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm: a scale; layernorm: a scale and a bias; nonparam_ln
    (olmo): no parameters (the reference's empty dict)."""

    def __init__(self, cfg: ModelConfig, shape_d: int, device):
        super().__init__()
        if cfg.norm in ("rmsnorm", "layernorm"):
            self.scale = param((shape_d,), cfg.pdtype, device, fill=1.0)
        if cfg.norm == "layernorm":
            self.bias = param((shape_d,), cfg.pdtype, device, fill=0.0)


def norm_fwd(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    """Statistics in f32, the normalized value cast to x's dtype before
    the affine."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (xf * r).to(x.dtype) * p.scale.to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)
    if cfg.norm == "layernorm":
        y = y * p.scale.to(x.dtype) + p.bias.to(x.dtype)
    return y


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  width: int | None = None) -> torch.Tensor:
    """RMSNorm of ``x * silu(z)`` (the Mamba2 and mLSTM output norms), the
    statistic in f32.  ``width``: on a mesh ``x`` holds this rank's heads
    of rows ``width`` wide, and the sum of squares is all-reduced over
    "model" before the rsqrt; its backward sums over "model" too
    (``copy_to_model``), since every rank's columns read the one
    statistic."""
    xf = (x * F.silu(z)).float()
    if width is None:
        ms = (xf * xf).mean(-1, keepdim=True)
    else:
        ss = C.copy_to_model((xf * xf).sum(-1, keepdim=True))
        ms = C.all_reduce_sum(ss, "model") / width
    r = torch.rsqrt(ms + 1e-6)
    return (xf * r).to(x.dtype) * scale.to(x.dtype)


def model_blocks(t: torch.Tensor, parts: int, mesh) -> list:
    """This rank's block along "model" of each of ``parts`` equal runs of
    the last dim of ``t``, a column-parallel output gathered whole over
    "model" first (``collectives.gather_for_split``): a rank's heads of
    [x | z], of gate-major [i | f] or [z | i | f | o], or its share of
    [u | g]."""
    t = C.gather_for_split(t, -1, mesh)
    md = mesh.size("model")
    v = t.reshape(*t.shape[:-1], parts, md, t.shape[-1] // (parts * md))
    return list(v[..., C.model_index(mesh), :].unbind(-2))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, device) -> torch.Tensor:
    rot = int(cfg.hd * cfg.rope_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_base ** exps)


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    rot = int(cfg.hd * cfg.rope_pct) // 2 * 2
    if rot == 0:
        return x
    ang = positions[..., None].float() * rope_freqs(cfg, x.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """The token table ``tok`` (vocab, d) and, unless the embeddings are
    tied, the output projection ``unembed`` (d, vocab)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.tok = param((cfg.vocab, cfg.d_model), cfg.pdtype, device, gen,
                         0.02)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.vocab), cfg.pdtype,
                                 device, gen, 0.02)


def _mesh():
    """The mesh of the enclosing serve context, or None."""
    return manual_dp_context()[0]


def embed_fwd(cfg: ModelConfig, p: Embed, inputs: torch.Tensor):
    """Tokens (B, S), or under ``input_mode="embeddings"`` precomputed
    embeddings (B, S, d) taken as they are, in the activation dtype.  On
    a mesh with the table's vocab over "model": each rank looks up the
    ids in its vocab block (zeros elsewhere) and one all-reduce adds the
    blocks; one term per token is nonzero, so the sum is exact."""
    if cfg.input_mode == "embeddings":
        return inputs.to(cfg.adtype)
    mesh, tok = _mesh(), p.tok
    if mesh is None or tok.shape[0] == cfg.vocab:
        return tok[inputs.long()].to(cfg.adtype)
    v_l = tok.shape[0]
    ids = inputs.long() - C.model_index(mesh) * v_l
    ok = (ids >= 0) & (ids < v_l)
    e = torch.where(ok[..., None], tok[ids.clamp(0, v_l - 1)],
                    torch.zeros((), dtype=tok.dtype, device=tok.device))
    return C.all_reduce_sum(e, "model").to(cfg.adtype)


def unembed_fwd(cfg: ModelConfig, p: Embed, x: torch.Tensor):
    """Logits (..., vocab); on a mesh with the vocab over "model" each
    rank computes its vocab block and the blocks are all-gathered (the
    input is the replicated input of a column-parallel projection)."""
    w = p.tok.T if cfg.tie_embeddings else p.unembed
    if _mesh() is None or w.shape[-1] == cfg.vocab:
        return x @ w.to(x.dtype)
    y = C.copy_to_model(x) @ w.to(x.dtype)
    return C.all_gather(y, "model", dim=-1)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

# jax.nn.gelu defaults to the tanh approximation
_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu, "tanh": torch.tanh}


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        s_in, s_out = d ** -0.5, f ** -0.5
        self.w_in = param((d, f), cfg.pdtype, device, gen, s_in)
        self.w_out = param((f, d), cfg.pdtype, device, gen, s_out)
        if cfg.gated_ffn:
            self.w_gate = param((d, f), cfg.pdtype, device, gen, s_in)


def _ffn(cfg: ModelConfig, w_in, w_gate, w_out, x):
    act = _ACT[cfg.act if cfg.act != "swiglu" else "silu"]
    h = x @ w_in.to(x.dtype)
    if cfg.gated_ffn:
        h = act(x @ w_gate.to(x.dtype)) * h
    else:
        h = act(h)
    return h @ w_out.to(x.dtype)


def ffn_fwd(cfg: ModelConfig, p: FFN, x: torch.Tensor) -> torch.Tensor:
    """The FFN.  On a mesh, Megatron-TP: d_ff sharded over "model" (the
    activation is elementwise, so each rank's d_ff block is its own), the
    data-sharded dims gathered at use, one all-reduce over "model"; in
    the backward the input's gradient is summed over "model" and the
    weights' reduce-scattered over the data axes."""
    w_gate = p.w_gate if cfg.gated_ffn else None
    if _mesh() is None:
        return _ffn(cfg, p.w_in, w_gate, p.w_out, x)
    if cfg.gated_ffn:
        w_in, w_gate, w_out = C.unshard(p.w_in, p.w_gate, p.w_out)
    else:
        w_in, w_out = C.unshard(p.w_in, p.w_out)
    return C.all_reduce_sum(_ffn(cfg, w_in, w_gate, w_out,
                                 C.copy_to_model(x)), "model")


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        s = d ** -0.5
        self.wq = param((d, nh * hd), cfg.pdtype, device, gen, s)
        self.wk = param((d, nkv * hd), cfg.pdtype, device, gen, s)
        self.wv = param((d, nkv * hd), cfg.pdtype, device, gen, s)
        self.wo = param((nh * hd, d), cfg.pdtype, device, gen,
                        (nh * hd) ** -0.5)
        if cfg.qkv_bias:
            self.bq = param((nh * hd,), cfg.pdtype, device, fill=0.0)
            self.bk = param((nkv * hd,), cfg.pdtype, device, fill=0.0)
            self.bv = param((nkv * hd,), cfg.pdtype, device, fill=0.0)


# one attention layer's weights as the forward uses them: the module's
# own, or on a mesh this rank's head block (biases sliced to match)
_AttnW = collections.namedtuple("_AttnW", "wq wk wv wo bq bk bv")


@functools.lru_cache(maxsize=None)
def _head_cfg(cfg: ModelConfig, n_heads: int, n_kv_heads: int):
    """``cfg`` with a rank's local head counts (head_dim pinned)."""
    return dataclasses.replace(cfg, n_heads=n_heads, n_kv_heads=n_kv_heads,
                               head_dim=cfg.hd)


def kv_split(cfg: ModelConfig, md: int) -> bool:
    """True where ranks of a model axis of ``md`` share a kv head: the kv
    heads do not divide over "model" and |model| is a multiple of them.
    ``sharding/rules._cache_rule`` then puts head_dim over "model" (which
    ``model.check_mesh_servable`` requires to divide), and each rank runs
    ``_attention_split``."""
    kv = cfg.n_kv_heads
    return kv % md != 0 and md % kv == 0


def _attn_weights(cfg: ModelConfig, p: Attention, mesh):
    """(cfg with this rank's head counts, its ``_AttnW``, whether it holds
    only part of a kv head).  On a mesh the projections' data-sharded
    dims are gathered (one collective) and the replicated qkv biases cut
    to the rank's columns (``model_columns``, whose backward gathers
    their gradients whole).  Where ranks share a kv head (``kv_split``)
    wk's and wv's columns are a slice of one kv head, and the rank's q
    heads all read that one head: its cfg counts one kv head."""
    bias = [getattr(p, n, None) for n in ("bq", "bk", "bv")]
    if mesh is None:
        return cfg, _AttnW(p.wq, p.wk, p.wv, p.wo, *bias), False
    wq, wk, wv, wo = C.unshard(p.wq, p.wk, p.wv, p.wo)
    bias = [b if b is None else C.model_columns(b, w.shape[1])
            for b, w in zip(bias, (wq, wk, wv))]
    split = kv_split(cfg, mesh.size("model"))
    return (_head_cfg(cfg, wq.shape[1] // cfg.hd,
                      1 if split else wk.shape[1] // cfg.hd),
            _AttnW(wq, wk, wv, wo, *bias), split)


def _project(cfg: ModelConfig, p, x: torch.Tensor):
    """The q, k and v projections, the biases (``qkv_bias``) added."""
    q, k, v = (x @ p.wq.to(x.dtype), x @ p.wk.to(x.dtype),
               x @ p.wv.to(x.dtype))
    if cfg.qkv_bias:
        q, k, v = (q + p.bq.to(x.dtype), k + p.bk.to(x.dtype),
                   v + p.bv.to(x.dtype))
    return q, k, v


def _qkv(cfg: ModelConfig, p, x: torch.Tensor):
    """The projections, the biases added before the head reshape."""
    b, s, _ = x.shape
    q, k, v = _project(cfg, p, x)
    return (q.reshape(b, s, cfg.n_heads, cfg.hd),
            k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def _repeat_kv(cfg: ModelConfig, k: torch.Tensor) -> torch.Tensor:
    """(B, S, Kh, hd) -> (B, S, H, hd) by repeating each kv head."""
    rep = cfg.n_heads // cfg.n_kv_heads
    return k if rep == 1 else k.repeat_interleave(rep, dim=2)


def flash_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """Blockwise attention with an online softmax: a loop over KV blocks
    inside a loop over Q blocks.  q: (B, Sq, H, hd); k, v: (B, Skv, H, hd).
    ``q_offset``: absolute position of q[0].  ``cfg.sliding_window`` > 0
    also masks keys ``win`` or more positions behind the query.  The
    reference's plain-JAX version step for step (f32 scores, the
    ``-1e30`` mask, probabilities cast to the value dtype, f32
    accumulators).  The reference checkpoints
    each block step for its backward; here autograd keeps the blocks'
    activations, and a training model under ``cfg.remat`` recomputes the
    whole transformer block instead (models/model.py)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    qb, kb = min(cfg.q_block, sq), min(cfg.kv_block, skv)
    assert sq % qb == 0 and skv % kb == 0, (sq, qb, skv, kb)
    scale = hd ** -0.5
    win = cfg.sliding_window
    outs = []
    for iq in range(sq // qb):
        qblk = q[:, iq * qb:(iq + 1) * qb]
        q_pos = q_offset + iq * qb + torch.arange(qb, device=q.device)
        acc = torch.zeros((b, h, qb, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, qb), -1e30, dtype=torch.float32,
                       device=q.device)
        l_ = torch.zeros((b, h, qb), dtype=torch.float32, device=q.device)
        for ik in range(skv // kb):
            kblk, vblk = k[:, ik * kb:(ik + 1) * kb], v[:, ik * kb:(ik + 1) * kb]
            s_ = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).float() * scale
            if causal or win:
                k_pos = ik * kb + torch.arange(kb, device=q.device)
                if causal:
                    s_ = torch.where(q_pos[:, None] >= k_pos[None, :], s_,
                                     -1e30)
                if win:
                    s_ = torch.where(q_pos[:, None] - k_pos[None, :] < win,
                                     s_, -1e30)
            m_new = torch.maximum(m, s_.amax(-1))
            p_ = torch.exp(s_ - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_ = l_ * alpha + p_.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p_.to(vblk.dtype), vblk).float()
            m = m_new
        out = acc / l_[..., None].clamp(min=1e-30)
        outs.append(out.transpose(1, 2).to(cfg.adtype))    # (b, qb, h, hd)
    return torch.cat(outs, 1)


def _gather_pages(pool: torch.Tensor, block_table: torch.Tensor):
    """A paged pool gathered back into a per-slot dense view.

    pool: (n_pages, page_size, Kh, hd); block_table: (B, n_pp) int32 with
    -1 marking unallocated entries.  Returns (B, n_pp * page_size, Kh, hd).
    Holes read page 0, as in the reference: every attended position
    (kpos <= pos) lies in a page the slot owns and the ``-1e30`` mask
    zeroes the rest.  With page_size dividing max_len the view has the
    dense cache's (B, max_len) reduction shape, so paged attention gives
    the dense cache's bits."""
    b, n_pp = block_table.shape
    g = pool[block_table.clamp(min=0).long()]
    return g.reshape(b, n_pp * pool.shape[1], *pool.shape[2:])


def _page_targets(bt: torch.Tensor, qpos: torch.Tensor, ok: torch.Tensor,
                  page_size: int, trash: int):
    """(page, offset) of each write at positions ``qpos`` (B, S) through
    the block table.  A write that is not ``ok``, lies past the table or
    meets an unallocated (-1) entry goes to page ``trash``, the pool's
    last page, which no block table names: the reference's ``mode="drop"``
    index ``n_pages``, made a real page (a -1 index would wrap onto the
    last live page instead)."""
    n_pp = bt.shape[1]
    pg_idx, within = qpos // page_size, qpos % page_size
    pg = torch.gather(bt, 1, pg_idx.clamp(max=n_pp - 1).long())
    pg = torch.where(ok & (pg_idx < n_pp) & (pg >= 0), pg, trash)
    return pg.long(), within.long()


def _write_dense(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 n_valid: torch.Tensor, start: int = 0,
                 total: int | None = None):
    """Write ``new`` (B, S, Kh, hd) at rows ``pos + i`` of a dense cache
    ``c`` (B, Skv, Kh, hd), IN PLACE, with the reference's ``mode="drop"``
    semantics: token i of slot b is written only if ``i < n_valid[b]``
    and ``pos[b] + i < Skv``.  A context-parallel rank's ``c`` holds rows
    [start, start + Skv) of a cache of ``total`` rows: it writes the
    tokens whose rows fall there.

    Torch has no dropping scatter, so every token writes somewhere in its
    own slot's rows (its position, clamped to the last row) and each
    position receives the value it must hold after the step: the new
    value of the valid token that owns it, else its old value.  Writers
    that share a position carry the same bits, so the scatter is exact
    whatever their order, and no write lands a wrong value on a live
    position.  No host sync."""
    b, s = new.shape[:2]
    skv = c.shape[1]
    total = skv if total is None else total
    tgt = ((pos[:, None] + torch.arange(s, device=c.device)).clamp(
        max=total - 1) - start).clamp(0, skv - 1).long()       # (B, S)
    owner = tgt + start - pos[:, None].long()                  # token index
    owned = (owner >= 0) & (owner < n_valid[:, None].long())
    rows = torch.arange(b, device=c.device)[:, None].expand(b, s)
    fresh = new[rows, owner.clamp(0, s - 1)].to(c.dtype)
    val = torch.where(owned[..., None, None], fresh, c[rows, tgt])
    c[rows, tgt] = val


def _context_parallel(cache: dict):
    """A context-parallel rank's cache (``activations.context_parallel``)
    as an ``activations.SeqShard`` (its first row and the whole cache's
    rows) where a dense or ring KV cache is split by sequence over the
    data axes, else None."""
    cp = context_parallel()
    if cp is None or "block_table" in cache:
        return None
    mesh, dp = cp
    n = cache["k"].shape[1]
    return SeqShard(mesh, dp, mesh.index(dp) * n, n * mesh.size(dp))


def _seq_slice(t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a whole prompt's k or v (B, S, ., hd) where a
    cache is split by sequence over the data axes, else ``t``."""
    cp = context_parallel()
    if cp is None:
        return t
    mesh, dp = cp
    n = t.shape[1] // mesh.size(dp)
    assert n * mesh.size(dp) == t.shape[1], (t.shape, mesh.size(dp))
    return t[:, mesh.index(dp) * n:(mesh.index(dp) + 1) * n].contiguous()


def _chunk_write(cfg: ModelConfig, k, v, cache: dict):
    """Chunked prefill's cache write: k/v (B, S, ., hd) of S prompt tokens
    per slot, each slot at its own offset ``cache["pos"]`` with
    ``cache["n_valid"]`` (B,) real tokens this chunk (the tail is
    padding).  Padded tokens and positions at or past the cache end write
    nothing (``_write_dense``; on a paged cache they and unallocated
    entries go to the trash page), IN PLACE.  The causal mask is per
    query (kpos <= pos + i), so a chunk attends as feeding its tokens one
    decode tick at a time.  Returns (keys, values, mask (B, S, Skv),
    cache with ``pos + n_valid``)."""
    sq = k.shape[1]
    pos, nv = cache["pos"], cache["n_valid"]
    off = torch.arange(sq, device=k.device)
    qpos = pos[:, None] + off[None, :]                         # (B, Sq)
    ck, cv = cache["k"], cache["v"]
    if "block_table" in cache:
        bt = cache["block_table"]
        page_size = ck.shape[1]
        skv = bt.shape[1] * page_size
        tok_ok = off[None, :] < nv[:, None]
        pg, within = _page_targets(bt, qpos, tok_ok, page_size,
                                   ck.shape[0] - 1)
        ck[pg, within] = k.to(ck.dtype)
        cv[pg, within] = v.to(cv.dtype)
        ak, av = _gather_pages(ck, bt), _gather_pages(cv, bt)
        new_cache = {"k": ck, "v": cv, "block_table": bt, "pos": pos + nv}
        start = 0
    else:
        skv, cp = ck.shape[1], _context_parallel(cache)
        start, total = (0, None) if cp is None else (cp.start, cp.total)
        _write_dense(ck, k, pos, nv, start, total)
        _write_dense(cv, v, pos, nv, start, total)
        ak, av = ck, cv
        new_cache = {"k": ck, "v": cv, "pos": pos + nv}
    valid = start + torch.arange(skv, device=k.device)[None, None, :] \
        <= qpos[:, :, None]                                    # (B, Sq, Skv)
    return ak, av, valid, new_cache


def _attention_chunk(cfg: ModelConfig, q, k, v, cache: dict):
    """Chunked-prefill attention against the DECODE cache layout: q/k/v
    (B, S, ., hd), ``_chunk_write`` then the attention.  Returns (out (B,
    S, H, hd), cache with ``pos + n_valid``)."""
    ak, av, valid, new_cache = _chunk_write(cfg, k, v, cache)
    return _attend(cfg, q, ak, av, valid,
                   _context_parallel(cache)).reshape(q.shape), new_cache


def _cache_write(cfg: ModelConfig, k, v, cache: dict):
    """This step's k/v (B, S, ., hd) written into ``cache`` IN PLACE: a
    chunk (``n_valid`` in the cache, ``_chunk_write``) or one decode
    token at each slot's ``pos`` (dense, paged or ring; ``attention_fwd``
    says where a write lands).  Returns (keys, values, mask (B, S or 1,
    Skv), new cache)."""
    if "n_valid" in cache:
        assert not cfg.sliding_window, \
            "chunked prefill targets dense decode caches; sliding-window " \
            "ring buffers feed their prompts token-by-token"
        return _chunk_write(cfg, k, v, cache)
    b = k.shape[0]
    pos = cache["pos"]
    ck, cv = cache["k"], cache["v"]
    if "block_table" in cache:
        assert not cfg.sliding_window, \
            "paged KV caches need absolute positions (no ring buffers)"
        bt = cache["block_table"]
        page_size = ck.shape[1]
        skv = bt.shape[1] * page_size
        pg_idx = (pos // page_size).clamp(max=bt.shape[1] - 1)
        pg = torch.gather(bt, 1, pg_idx.long()[:, None])[:, 0]
        pg = torch.where(pg >= 0, pg, ck.shape[0] - 1).long()
        off = (pos % page_size).long()
        ck[pg, off] = k[:, 0].to(ck.dtype)
        cv[pg, off] = v[:, 0].to(cv.dtype)
        ak, av = _gather_pages(ck, bt), _gather_pages(cv, bt)
        new_cache = {"k": ck, "v": cv, "block_table": bt, "pos": pos + 1}
        valid = torch.arange(skv, device=k.device)[None, :] <= pos[:, None]
    else:
        rows = torch.arange(b, device=k.device)
        skv = total = ck.shape[1]
        kpos = torch.arange(skv, device=k.device)[None, :]
        cp = _context_parallel(cache)
        if cp is not None:                  # rows [start, start + skv)
            kpos, total = kpos + cp.start, cp.total
        if cfg.sliding_window:                          # ring buffer
            row = pos % total
            valid = (kpos <= row[:, None]) | (pos[:, None] >= total)
        else:
            row = pos.clamp(max=total - 1)
            valid = kpos <= pos[:, None]
        row = row.long()
        if cp is None:
            ck[rows, row] = k[:, 0].to(ck.dtype)
            cv[rows, row] = v[:, 0].to(cv.dtype)
        else:
            # written where the row falls in this rank's slice (the
            # reference's mode="drop" elsewhere), masked on the device
            mine = ((row >= cp.start) & (row < cp.start + skv))[:, None, None]
            row = (row - cp.start).clamp(0, skv - 1)
            for c, t in ((ck, k), (cv, v)):
                c[rows, row] = torch.where(mine, t[:, 0].to(c.dtype),
                                           c[rows, row])
        ak, av = ck, cv
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}
    return ak, av, valid[:, None], new_cache


def _attend(cfg: ModelConfig, q, ak, av, valid, cp=None):
    """GQA attention of q (B, Sq, H, hd) over keys and values (B, Skv,
    Kh, hd) where ``valid`` (B, Sq or 1, Skv): (B, Sq, H * hd).  Over a
    rank's slice of the sequence (``cp``) the softmax's parts combine over
    the data axes (``_combine_over_data``)."""
    b, sq = q.shape[0], q.shape[1]
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, sq, cfg.n_kv_heads, rep, cfg.hd)
    s_ = torch.einsum("bqgrd,bkgd->bgrqk", qg, ak).float() * cfg.hd ** -0.5
    s_ = torch.where(valid[:, None, None], s_, -1e30)
    if cp is None:
        w = torch.softmax(s_, dim=-1).to(av.dtype)
        o = torch.einsum("bgrqk,bkgd->bqgrd", w, av)
        return o.reshape(b, sq, cfg.n_heads * cfg.hd)
    p, m, l_ = _softmax_parts(s_, valid[:, None, None])
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(av.dtype), av)
    m, l_ = (t.permute(0, 3, 1, 2).reshape(b, sq, cfg.n_heads)
             for t in (m, l_))
    o = _combine_over_data(o.reshape(b, sq, cfg.n_heads, cfg.hd), m, l_, cp)
    return o.reshape(b, sq, cfg.n_heads * cfg.hd).to(av.dtype)


def _softmax_parts(s_, valid):
    """The softmax's parts over a rank's keys (f32 scores ``s_``, masked
    to -1e30 where not ``valid``): the unnormalized weights exp(s - m),
    0 where masked, the max m and their sum l."""
    m = s_.amax(-1)
    p = torch.where(valid, torch.exp(s_ - m[..., None]), 0.0)
    return p, m, p.sum(-1)


def _combine_over_data(o, m, l_, cp):
    """Attention over a sequence split across the data axes: each rank's
    unnormalized output o (B, Sq, H, hd) with its max and sum (B, Sq, H)
    gathered over them (one collective, f32) and added by log-sum-exp in
    rank order, so every data rank holds the same bits.  A rank with no
    valid key (m = -1e30, l = 0) adds zeros.  Returns f32 (B, Sq, H,
    hd)."""
    hd = o.shape[-1]
    part = torch.cat([o.float(), m[..., None], l_[..., None]], -1)
    every = C.all_gather(part[None], cp.dp, 0, cp.mesh).unbind(0)
    mx = torch.stack([e[..., hd] for e in every]).amax(0)
    acc, tot = torch.zeros_like(every[0][..., :hd]), torch.zeros_like(mx)
    for e in every:
        a = torch.exp(e[..., hd] - mx)
        acc = acc + e[..., :hd] * a[..., None]
        tot = tot + e[..., hd + 1] * a
    return acc / tot.clamp(min=1e-30)[..., None]


def attention_fwd(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                  positions: torch.Tensor, cache: dict | None = None):
    """Self-attention.  Without a cache: full-sequence flash attention
    (prefill), returning the post-RoPE K/V as the new cache.  With a
    cache carrying ``n_valid``: the chunked-prefill path
    (``_chunk_write``).  Otherwise single-step decode: x (B, 1, d),
    this step's K/V written at each slot's ``pos`` IN PLACE (the
    reference returns an updated copy of its donated cache), attention
    over positions ``<= pos``.

    A cache carrying ``block_table`` is PAGED (``init_attn_cache(
    page_size=)``): k/v are pools (n_pages + 1, page_size, Kh, hd) whose
    last page is the trash page, the block table (B, n_pp) maps each
    slot's page index to a pool page (-1 = unallocated, written to the
    trash page), and attention runs over the gathered per-slot view,
    the dense reduction shape.  Returns (out (B, S, d), new_cache).

    A decode at ``pos >= Skv`` computes what the reference computes, with
    no host read: on a dense cache the write lands on row ``Skv - 1``
    (the reference's ``dynamic_update_slice`` clamps its start); on a
    paged cache the page index clamps onto the block table's last entry
    and the write lands at offset ``pos % page_size`` of that page (a -1
    entry still sends it to the trash page); attention then covers every
    position.

    Sliding window (``cfg.sliding_window`` > 0): the dense cache is a
    RING BUFFER of Skv = min(max_len, window) rows.  Decode writes at row
    ``pos % Skv`` (it wraps, never clamps) and attends to rows ``<= pos %
    Skv`` until the ring has filled (``pos >= Skv``), then to every row.
    Ring buffers take neither a paged cache nor chunked prefill (their
    prompts go token by token), as in the reference.

    On a mesh (module docstring) the rank attends over its own heads
    against its own cache rows and heads, and the output projection's
    partial sums are all-reduced over "model"; in the backward the
    input's gradient is summed over "model" (every head block's
    projections read it).  Where a rank holds only part of a kv head
    (``kv_split``): ``_attention_split``."""
    mesh = _mesh()
    hcfg, w, split = _attn_weights(cfg, p, mesh)
    if mesh is None:
        return _attention(hcfg, w, x, positions, cache)
    x = C.copy_to_model(x)
    out, new_cache = _attention_split(cfg, hcfg, w, x, positions, cache,
                                      mesh) if split \
        else _attention(hcfg, w, x, positions, cache)
    return C.all_reduce_sum(out, "model"), new_cache


def _attention(cfg: ModelConfig, p, x, positions, cache):
    b, sq = x.shape[0], x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    if cache is None:
        o = _self_attention(cfg, q, k, v)
        o = o.reshape(b, sq, cfg.n_heads * cfg.hd)
        return o @ p.wo.to(o.dtype), {"k": _seq_slice(k),
                                      "v": _seq_slice(v)}
    ak, av, valid, new_cache = _cache_write(cfg, k, v, cache)
    o = _attend(cfg, q, ak, av, valid, _context_parallel(cache))
    return o @ p.wo.to(o.dtype), new_cache


def _self_attention(cfg: ModelConfig, q, k, v):
    """Causal self-attention of q (B, Sq, H, hd) over k and v (B, Sq, Kh,
    hd) of the same positions (``flash_attention``).  Under a sequence
    split over the data axes (``activations.sequence_shard``) they are
    the rank's slice of the positions: k and v are gathered whole along
    S (``sharding/sequence.gather_sequence``, whose backward
    reduce-scatters), cut at the first key block past the rank's last
    query, and the queries sit at their global positions (``q_offset``),
    so the causal and window masks hold as on one device."""
    shard = sequence_shard(q.shape[1])
    if shard is None:
        return flash_attention(cfg, q, _repeat_kv(cfg, k), _repeat_kv(cfg, v))
    kb = min(cfg.kv_block, shard.total)
    upto = -(-(shard.start + q.shape[1]) // kb) * kb
    k, v = (gather_sequence(t, shard, upto) for t in (k, v))
    return flash_attention(cfg, q, _repeat_kv(cfg, k), _repeat_kv(cfg, v),
                           q_offset=shard.start)


def _attention_split(cfg: ModelConfig, hcfg: ModelConfig, p, x, positions,
                     cache, mesh):
    """One rank's attention where the kv heads are fewer than the model
    ranks (``kv_split``): s = |model| / Kh ranks share each kv
    head.  The rank's wq columns are its H / |model| q heads, all of kv
    head ``rank // s``; its wk and wv columns are a 1 / s slice of that
    head; its cache holds head_dim / |model| dims of EVERY kv head
    (``rules.cache_pspecs``).  ``hcfg``: the rank's q heads over one kv
    head.

    The new tokens' k and v columns are gathered whole over "model" in
    one collective (``gather_for_split``: each rank reads another kv head
    of them, so the backward reduce-scatters), RoPE'd whole, and the
    rank's head_dim slice of every kv head is what it writes to its cache
    (or returns as the prefill cache).  Without a cache (prefill,
    training) the rank attends with its own kv head, as one device.
    Over a cache, of two exchanges the one that moves fewer bytes
    (``_scores_cheaper``): gather the rank's kv head from the head_dim
    slices (``all_to_all``; then as one device), or exchange partial
    scores (``_attend_scores``)."""
    b, sq = x.shape[0], x.shape[1]
    md, kvh, hd = mesh.size("model"), cfg.n_kv_heads, cfg.hd
    s, r = md // kvh, C.model_index(mesh)
    q, k, v = _project(cfg, p, x)
    q = apply_rope(cfg, q.reshape(b, sq, hcfg.n_heads, hd), positions)
    kv = C.gather_for_split(torch.stack([k, v], 2), -1, mesh)
    k = apply_rope(cfg, kv[:, :, 0].reshape(b, sq, kvh, hd), positions)
    v = kv[:, :, 1].reshape(b, sq, kvh, hd)
    dims = slice(r * hd // md, (r + 1) * hd // md)
    kc, vc = k[..., dims], v[..., dims]
    if cache is None:
        # the rank's kv head, contiguous as ``_attention`` gives its heads
        kh, vh = (t[:, :, r // s:r // s + 1].contiguous() for t in (k, v))
        o = _self_attention(hcfg, q, kh, vh)
        o = o.reshape(b, sq, hcfg.n_heads * hd)
        return o @ p.wo.to(o.dtype), {"k": _seq_slice(kc).contiguous(),
                                      "v": _seq_slice(vc).contiguous()}
    ak, av, valid, new_cache = _cache_write(cfg, kc, vc, cache)
    cp = _context_parallel(cache)
    if _scores_cheaper(sq, ak.shape[1], hcfg.n_heads, hd, md,
                       ak.element_size()):
        o = _attend_scores(cfg, q, ak, av, valid, mesh, cp)
    else:
        ak, av = (C.all_to_all(t.repeat_interleave(s, dim=2), 2, 3,
                               mesh=mesh) for t in (ak, av))
        o = _attend(hcfg, q, ak, av, valid, cp)
    return o @ p.wo.to(o.dtype), new_cache


def _scores_cheaper(sq: int, skv: int, hq: int, hd: int, md: int,
                    a: int) -> bool:
    """Whether ``_attend_scores`` sends fewer bytes a rank than gathering
    the rank's kv head (both as ``collectives.WIRE`` counts them, over
    (|model| - 1) x B): the partial scores' reduce-scatter (f32) and the
    weights' gather (``a`` bytes an element), sq x hq x skv x (4 + a),
    plus q's and the output's all-to-all, 2 sq hq hd a / |model|; against
    k's and v's all-to-all, 2 skv hd a / |model|.  Scaled by |model|."""
    return sq * hq * (skv * (4 + a) * md + 2 * hd * a) < 2 * skv * hd * a


def _attend_scores(cfg: ModelConfig, q, ak, av, valid, mesh, cp=None):
    """Attention of the rank's q heads q (B, Sq, hq, hd) over a cache
    that holds this rank's head_dim slice of every kv head, ak and av
    (B, Skv, Kh, hd / |model|), by exchanging partial scores: every q
    head at this rank's dims (``all_to_all``), the partial scores of
    every head in f32, summed over "model" onto the heads' ranks
    (``reduce_scatter``, in rank order), the softmax of the rank's heads,
    the weights gathered (``all_gather``), the partial outputs of every
    head at this rank's dims, and the rank's heads' outputs at every dim
    (``all_to_all``).  Over a rank's slice of the sequence (``cp``) the
    weights are the softmax's unnormalized parts, combined over the data
    axes at the end (``_combine_over_data``).  Returns (B, Sq, hq * hd)."""
    b, sq, hq, hd = q.shape
    kvh, h = cfg.n_kv_heads, cfg.n_heads
    qa = C.all_to_all(q, 3, 2, mesh=mesh)              # (B, Sq, H, hd/md)
    part = torch.einsum("bqgrd,bkgd->bgrqk",
                        qa.reshape(b, sq, kvh, h // kvh, -1).float(),
                        ak.float())
    s_ = C.reduce_scatter(part.reshape(b, h, sq, -1), 1, mesh=mesh) \
        * hd ** -0.5                                   # (B, hq, Sq, Skv)
    s_ = torch.where(valid[:, None], s_, -1e30)
    if cp is None:
        w = torch.softmax(s_, dim=-1).to(av.dtype)
    else:
        w, m, l_ = _softmax_parts(s_, valid[:, None])
        w = w.to(av.dtype)
    wa = C.all_gather(w, "model", 1, mesh)             # (B, H, Sq, Skv)
    o = torch.einsum("bgrqk,bkgd->bqgrd",
                     wa.reshape(b, kvh, h // kvh, sq, -1), av)
    o = C.all_to_all(o.reshape(b, sq, h, -1), 2, 3, mesh=mesh)
    if cp is not None:
        o = _combine_over_data(o, m.transpose(1, 2), l_.transpose(1, 2),
                               cp).to(av.dtype)
    return o.reshape(b, sq, hq * hd)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device, *,
                    page_size: int = 0, n_pages: int = 0):
    """Decode KV cache; ``pos`` is per-slot (continuous batching).

    ``page_size > 0`` builds the PAGED layout: k/v become a pool of
    ``n_pages`` blocks of (page_size, Kh, hd) shared by every slot, PLUS
    one trash page at index ``n_pages`` that takes the writes the
    reference drops (``mode="drop"`` at index n_pages) and that no block
    table names; and a ``block_table`` (batch, max_len // page_size)
    int32 mapping each slot's page index to a pool page (-1 =
    unallocated).  ``page_size`` must divide ``max_len`` so the gathered
    per-slot view keeps the dense reduction shape.  A sliding-window
    config gets a ring buffer of min(max_len, window) rows, and no paged
    layout."""
    if page_size:
        assert not cfg.sliding_window, \
            "paged KV caches need absolute positions (no ring buffers)"
        assert max_len % page_size == 0, (
            f"page_size={page_size} must divide max_len={max_len}")
        assert n_pages >= 1, f"paged cache needs n_pages >= 1, got {n_pages}"
        shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.adtype, device=device),
                "block_table": torch.full((batch, max_len // page_size), -1,
                                          dtype=torch.int32, device=device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
