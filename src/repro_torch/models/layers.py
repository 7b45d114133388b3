"""Shared LM layers (counterpart of ``repro/models/layers.py``): the norms,
RoPE, embeddings, the gated FFN and GQA decode attention over a dense KV
cache.

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
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def param(shape, dtype, device, gen=None, scale=None, fill=None):
    """A frozen parameter: ``fill`` everywhere, normal(0, 1) * ``scale``
    from ``gen``, or uninitialized storage when neither is given."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    elif gen is not None:
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device).mul_(scale).to(dtype)
    else:
        t = torch.empty(shape, dtype=dtype, device=device)
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm: a scale; layernorm: a scale and a bias."""

    def __init__(self, cfg: ModelConfig, shape_d: int, device):
        super().__init__()
        if cfg.norm not in ("rmsnorm", "layernorm"):
            raise NotImplementedError(
                f"norm {cfg.norm!r} is not ported yet (ROADMAP queue 1, "
                "item 9)")
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
    return y * p.scale.to(x.dtype) + p.bias.to(x.dtype)


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
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        if cfg.tie_embeddings or cfg.input_mode != "tokens":
            raise NotImplementedError(
                "tied embeddings and embedding inputs are not ported yet "
                "(ROADMAP queue 1, item 9)")
        self.tok = param((cfg.vocab, cfg.d_model), cfg.pdtype, device, gen,
                         0.02)
        self.unembed = param((cfg.d_model, cfg.vocab), cfg.pdtype, device,
                             gen, 0.02)


def embed_fwd(cfg: ModelConfig, p: Embed, tokens: torch.Tensor):
    return p.tok[tokens.long()].to(cfg.adtype)


def unembed_fwd(cfg: ModelConfig, p: Embed, x: torch.Tensor):
    return x @ p.unembed.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        if cfg.act not in ("silu", "swiglu"):
            raise NotImplementedError(
                f"FFN activation {cfg.act!r} is not ported yet (ROADMAP "
                "queue 1, item 9)")
        d, f = cfg.d_model, cfg.d_ff
        s_in, s_out = d ** -0.5, f ** -0.5
        self.w_in = param((d, f), cfg.pdtype, device, gen, s_in)
        self.w_out = param((f, d), cfg.pdtype, device, gen, s_out)
        if cfg.gated_ffn:
            self.w_gate = param((d, f), cfg.pdtype, device, gen, s_in)


def ffn_fwd(cfg: ModelConfig, p: FFN, x: torch.Tensor) -> torch.Tensor:
    h = x @ p.w_in.to(x.dtype)
    if cfg.gated_ffn:
        h = F.silu(x @ p.w_gate.to(x.dtype)) * h
    else:
        h = F.silu(h)
    return h @ p.w_out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (decode over a dense KV cache)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        if cfg.qkv_bias or cfg.sliding_window:
            raise NotImplementedError(
                "qkv biases and sliding-window attention are not ported yet "
                "(ROADMAP queue 1, item 9)")
        d, hd = cfg.d_model, cfg.hd
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        s = d ** -0.5
        self.wq = param((d, nh * hd), cfg.pdtype, device, gen, s)
        self.wk = param((d, nkv * hd), cfg.pdtype, device, gen, s)
        self.wv = param((d, nkv * hd), cfg.pdtype, device, gen, s)
        self.wo = param((nh * hd, d), cfg.pdtype, device, gen,
                        (nh * hd) ** -0.5)


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor):
    b, s, _ = x.shape
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (x @ p.wk.to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (x @ p.wv.to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def attention_fwd(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                  positions: torch.Tensor, cache: dict):
    """Single-step decode against a dense KV cache.

    x: (B, 1, d); cache: {"k", "v": (B, Skv, Kh, hd), "pos": (B,) int32}.
    Writes this step's K/V at each slot's ``pos`` IN PLACE (the reference
    returns an updated copy of its donated cache) and attends over
    positions ``<= pos``.  Returns (out (B, 1, d), cache with ``pos + 1``).
    The caller guarantees ``pos < Skv`` (model.decode checks it once per
    step): the reference's dynamic-update-slice would clamp there.
    """
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    pos = cache["pos"].long()
    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(b, device=x.device)
    ck[rows, pos] = k[:, 0].to(ck.dtype)
    cv[rows, pos] = v[:, 0].to(cv.dtype)
    skv = ck.shape[1]
    valid = torch.arange(skv, device=x.device)[None, :] <= pos[:, None]
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, q.shape[1], cfg.n_kv_heads, rep, cfg.hd)
    s_ = torch.einsum("bqgrd,bkgd->bgrqk", qg, ck).float() * cfg.hd ** -0.5
    s_ = torch.where(valid[:, None, None, None, :], s_, -1e30)
    w = torch.softmax(s_, dim=-1).to(cv.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", w, cv)
    o = o.reshape(b, q.shape[1], cfg.n_heads * cfg.hd)
    new_cache = {"k": ck, "v": cv, "pos": cache["pos"] + 1}
    return o @ p.wo.to(o.dtype), new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Dense decode KV cache; ``pos`` is per-slot (continuous batching)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
