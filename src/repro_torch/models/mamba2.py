"""Mamba2 (State-Space Duality) block (counterpart of
``repro/models/mamba2.py``), chunked-scan formulation.

The SSD recurrence  h_t = exp(a_t) * h_{t-1} + b_t x_t^T,  y_t = c_t^T h_t
with a scalar log-decay per head a_t = -softplus(dt) * exp(a_log).
Prefill and training use the chunkwise algorithm: a within-chunk
quadratic term plus the cross-chunk state carried by a loop over chunks,
so memory is O(S * chunk).  Decode is the O(1) recurrent update.  Plain
PyTorch, as it is plain JAX in the reference; the state and every sum the
reference takes in f32 are f32 here.

State layout: h (B, H, P, N) with P = head dim, N = d_state.

On a mesh (inside ``runtime/steps.serve_mesh_context`` or
``train_mesh_context``) the block is tensor-parallel over "model" by
heads, each rank holding its heads' state and the data-sharded dims of
its weights gathered at use (``collectives.unshard``).  ``w_dt`` and
``w_out`` are head-aligned as stored (column and row split).  ``w_xz``
is [x | z] and ``w_bc`` is [B | C], so a contiguous column split hands
one rank x and another z: their outputs are gathered whole over "model"
(``collectives.gather_for_split``, whose backward reduce-scatters) and
each rank takes x and z of its heads, and B and C whole (every head
reads them).  The replicated per-head leaves are cut to the rank's heads
(``model_columns``), the gated RMSNorm's sum of squares is all-reduced
over "model", and the output projection's partial sums too.
"""
from __future__ import annotations

import collections

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import manual_dp_context
from repro_torch.sharding.sequence import in_order


def mamba_dims(cfg: ModelConfig):
    """(d_in, n_heads, head dim P, d_state N)."""
    d_in = cfg.ssm.expand * cfg.d_model
    return d_in, d_in // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.d_state


class Mamba(nn.Module):
    """The Mamba2 core's parameters (the reference's ``init_mamba``)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d = cfg.d_model
        d_in, n_heads, _, n = mamba_dims(cfg)
        s, dt = d ** -0.5, cfg.pdtype
        # input projections: x (value path) and z (gate), B and C, dt
        self.w_xz = L.param((d, 2 * d_in), dt, device, gen, s)
        self.w_bc = L.param((d, 2 * n), dt, device, gen, s)
        self.w_dt = L.param((d, n_heads), dt, device, gen, s)
        self.dt_bias = L.param((n_heads,), dt, device, fill=0.0)
        a_log = torch.log(torch.linspace(1.0, 16.0, n_heads,
                                         dtype=torch.float32))
        self.a_log = nn.Parameter(a_log.to(dtype=dt, device=device),
                                  requires_grad=False)
        self.d_skip = L.param((n_heads,), dt, device, fill=1.0)
        self.w_out = L.param((d_in, d), dt, device, gen, d_in ** -0.5)
        self.norm_scale = L.param((d_in,), dt, device, fill=1.0)


# one core's weights as a mesh rank uses them (its heads)
_MambaW = collections.namedtuple(
    "_MambaW", "w_xz w_bc w_dt dt_bias a_log d_skip w_out norm_scale")


def _rank_weights(cfg: ModelConfig, p: Mamba, mesh):
    """(this rank's head count, the core's weights as the forward uses
    them): every head and the module itself, or on a mesh the rank's
    heads."""
    if mesh is None:
        return mamba_dims(cfg)[1], p
    w_xz, w_bc, w_dt, w_out = C.unshard(p.w_xz, p.w_bc, p.w_dt, p.w_out)
    h_l, n_heads = w_dt.shape[1], mamba_dims(cfg)[1]
    # a per-head leaf (H,) or a per-channel one (H * P,): its rank's heads
    cut = lambda v: C.model_columns(v, v.shape[0] // n_heads * h_l)
    return h_l, _MambaW(w_xz, w_bc, w_dt, cut(p.dt_bias), cut(p.a_log),
                        cut(p.d_skip), w_out, cut(p.norm_scale))


def _proj(cfg: ModelConfig, p, u: torch.Tensor, n_heads: int | None = None,
          mesh=None):
    """The shared input projections of ``n_heads`` heads (default all;
    ``p`` a ``Mamba`` or a ``_MambaW``).  u: (B, S, d).  Returns xh (B,
    S, H, P), z (B, S, H * P), b and c (B, S, N), dt and its log-decay da
    (B, S, H), the last two in f32.  On a mesh the rank's heads (module
    docstring)."""
    p_hd = cfg.ssm.head_dim
    n_heads = n_heads or mamba_dims(cfg)[1]
    xz, bc = u @ p.w_xz.to(u.dtype), u @ p.w_bc.to(u.dtype)
    if mesh is None:
        x, z = xz.chunk(2, dim=-1)
        b, c = bc.chunk(2, dim=-1)
    else:
        x, z = L.model_blocks(xz, 2, mesh)
        b, c = C.gather_for_split(bc, -1, mesh).chunk(2, dim=-1)
    # jax.nn.softplus's formula, logaddexp(x, 0)
    dt = torch.logaddexp((u @ p.w_dt.to(u.dtype)).float() + p.dt_bias.float(),
                         torch.zeros((), device=u.device))
    da = dt * -torch.exp(p.a_log.float())
    xh = x.reshape(*x.shape[:-1], n_heads, p_hd)
    return xh, z, b, c, dt, da


def _chunk_step(h, xc, bc_, cc, dtc, dac, mask):
    """One chunk of the SSD: the incoming state's contribution, the
    within-chunk term, and the state carried out.  Returns (h', y (B, ck,
    H, P) f32)."""
    cum = torch.cumsum(dac, 1)                          # (B, ck, H)
    total = cum[:, -1]                                  # (B, H)
    cf, bf, xf = cc.float(), bc_.float(), xc.float()
    # 1) the incoming state: y[t] = c_t (prod of decays up to t) h
    y_state = torch.einsum("bln,bhpn->blhp", cf, h) \
        * torch.exp(cum)[..., None]
    # 2) within the chunk: L[t, s] = exp(cum_t - cum_s) for s <= t; masked
    # BEFORE the exp (an overflowing upper triangle NaNs the backward of
    # where(mask, exp(rel), 0) through a 0 * inf cotangent)
    rel = cum[:, :, None, :] - cum[:, None, :, :]       # (B, ck, ck, H)
    rel = torch.where(mask[None, :, :, None], rel, -1e30)
    scores = torch.einsum("bln,bsn->bls", cf, bf)       # (B, ck, ck)
    w = scores[..., None] * torch.exp(rel)              # (B, l, s, H)
    # the reference's contraction order: dt * x first, then over s
    y_intra = torch.einsum("blsh,bshp->blhp", w, dtc[..., None] * xf)
    # 3) h' = exp(total) h + sum_s exp(total - cum_s) dt_s x_s b_s^T,
    # contracted over s without the (B, ck, H, P, N) outer product
    xz = xf * (torch.exp(total[:, None] - cum) * dtc)[..., None]
    h = h * torch.exp(total)[..., None, None] \
        + torch.einsum("bshp,bsn->bhpn", xz, bf)
    return h, y_state + y_intra


def _ssd(ck: int, xh, b, c, dt, da, h):
    """The chunked SSD over S steps (chunks of ``ck``, which must divide
    S) from the state h.  Returns (y (B, S, H, P) f32 without the skip
    term, (h',))."""
    s = xh.shape[1]
    assert s % ck == 0, (s, ck)
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                 device=xh.device))
    ys = []
    for i in range(0, s, ck):
        sl = slice(i, i + ck)
        h, yc = _chunk_step(h, xh[:, sl], b[:, sl], c[:, sl], dt[:, sl],
                            da[:, sl], mask)
        ys.append(yc)
    return torch.cat(ys, 1), (h,)


def mamba_fwd(cfg: ModelConfig, p: Mamba, u: torch.Tensor,
              state: dict | None = None):
    """Mamba2 SSD.  u: (B, S, d) -> (y (B, S, d), {"h": (B, H, P, N)}).

    With a ``state`` and S == 1: the O(1) decode update.  Otherwise the
    chunked SSD over chunks of ``min(ssm.chunk, S)`` (S must divide),
    from ``state["h"]`` or zeros.  On a mesh ``u`` is the rank's rows,
    the state its rows and heads, and y the rank's rows, whole; under a
    sequence split (``sharding/sequence.in_order``) ``u`` is the rank's
    slice of the positions, the chunks those of the slice, and the state
    handed from slice to slice (the returned one the whole sequence's)."""
    mesh = manual_dp_context()[0]
    n_heads, w = _rank_weights(cfg, p, mesh)
    if mesh is not None:
        u = C.copy_to_model(u)
    bsz, s, _ = u.shape
    xh, z, b, c, dt, da = _proj(cfg, w, u, n_heads, mesh)
    d_in, _, p_hd, n = mamba_dims(cfg)
    d_skip = w.d_skip.float()
    if state is not None and s == 1:
        # h = exp(da) h + dt x b^T ; y = h c
        x0 = xh[:, 0].float()
        xb = torch.einsum("bhp,bn->bhpn", x0, b[:, 0].float())
        h = state["h"] * torch.exp(da[:, 0])[..., None, None] \
            + xb * dt[:, 0][..., None, None]
        y = torch.einsum("bhpn,bn->bhp", h, c[:, 0].float())
        y = y + x0 * d_skip[None, :, None]
    else:
        h = state["h"] if state is not None else torch.zeros(
            (bsz, n_heads, p_hd, n), dtype=torch.float32, device=u.device)
        ck = min(cfg.ssm.chunk, s)
        y, (h,) = in_order(lambda *a: _ssd(ck, *a), (xh, b, c, dt, da),
                           (h,), s)
        y = y + xh.float() * d_skip[None, None, :, None]
    y = y.reshape(bsz, s, n_heads * p_hd).to(u.dtype)
    y = L.gated_rmsnorm(y, z, w.norm_scale,
                        None if mesh is None else d_in)
    out = y @ w.w_out.to(u.dtype)
    if mesh is not None:
        out = C.all_reduce_sum(out, "model")
    return out, {"h": h}


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> dict:
    _, n_heads, p_hd, n = mamba_dims(cfg)
    return {"h": torch.zeros((batch, n_heads, p_hd, n), dtype=torch.float32,
                             device=device)}

