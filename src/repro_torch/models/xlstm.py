"""xLSTM blocks (counterpart of ``repro/models/xlstm.py``): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, sequential
recurrence with block-diagonal recurrent weights).

mLSTM recurrence (per head, stabilized in f32):
    C_t = f_t * C_{t-1} + i_t * v_t k_t^T        C: (hd_v, hd_qk)
    n_t = f_t * n_{t-1} + i_t * k_t              n: (hd_qk,)
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
with f_t = sigmoid(f~_t) (log-space cumulative products) and
i_t = exp(min(i~_t, CLAMP)).  Prefill uses the chunkwise algorithm
(within-chunk quadratic term + cross-chunk state carry), decode the O(1)
update.  The mLSTM is plain PyTorch, as it is plain JAX in the reference.

The sLSTM runs its whole time loop in one launch of the hand-written
recurrence kernel (kernels/slstm_scan.py) where the reference scans its
``_slstm_cell``.  The kernel keeps the recurrent product ``rec`` and
``xg + rec`` in f32, as the reference's TPU kernel does; the reference's
layer computes both in the activation dtype.  In float32 the two agree;
in bfloat16 the port equals the reference's kernel fed the layer's ``xg``
and ``w_h``.

Deviations from the official xLSTM code (as in the reference): no causal
conv1d front, qk dim = d_in/2, sigmoid forget gate.

On a mesh (inside ``runtime/steps.serve_mesh_context`` or
``train_mesh_context``) both blocks are tensor-parallel over "model" by
heads, each rank holding its heads' state, with the data-sharded dims of
the weights gathered at use (``collectives.unshard``).  The mLSTM's
``w_q``, ``w_k``, ``w_v``, ``w_z`` (column) and ``w_out`` (row) are
head-aligned as stored; ``w_if`` is [i | f] per head, so its output is
gathered over "model" (``collectives.gather_for_split``, whose backward
reduce-scatters) and each rank takes i and f of its heads; the gated
RMSNorm's sum of squares is all-reduced over "model".  The sLSTM's
``w_x`` is gate-major [z | i | f | o]: its output is gathered the same
way and each rank takes the four gates of its heads; ``w_h`` (H, hd,
4 hd), whose 4 hd columns the rules split, is gathered whole and each
rank runs the recurrence kernel on its H / |model| heads.  The ranks'
``ys`` are gathered into y (B, S, d) for the GeGLU, whose [u | g]
output each rank cuts to its d_up share, and ``w_down`` is row-parallel
with the partial sums all-reduced.  Replicated leaves (``b_if``, ``b``,
``norm_scale``) are cut to the rank's heads (``model_columns``).

With fewer heads than model ranks (``heads_below_model``: |model| a
multiple of H, s = |model| / H ranks a head) the rules still split d_qk,
d_in and 4d over "model", so a rank holds 1 / s of one head's q, k and v
columns, and the heads do not divide: the states are whole on every rank.
The mLSTM then runs ``_mlstm_shared`` (its docstring gives the exchanges
and their bytes): every head's gates, the head's whole q and k gathered,
the rank's v rows of head r // s, the state gathered whole.  The sLSTM's
one recurrence a head cannot be split across processes, so every rank
runs every head (its gates and ``w_h`` gathered whole): the state stays
exact and equal on every rank, the gathered ``ys`` is y, and each rank's
partial gradients meet in the gathers' reduce-scatters.
"""
from __future__ import annotations

import collections

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.slstm_scan import slstm_scan, slstm_scan_trainable
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import manual_dp_context
from repro_torch.sharding.sequence import in_order

I_CLAMP = 8.0  # clamp on the exponential input gate pre-activation


def _const(values, dtype, device) -> nn.Parameter:
    """A frozen parameter holding the initial ``values`` (training turns
    ``requires_grad`` on, as for every parameter)."""
    t = torch.tensor(values, dtype=torch.float32).to(dtype=dtype,
                                                     device=device)
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig):
    d = cfg.d_model
    d_in = cfg.ssm.expand * d          # value / gate width
    d_qk = d_in // 2                   # query/key width
    h = cfg.n_heads
    return d, d_in, d_qk, h, d_in // h, d_qk // h


class MLSTM(nn.Module):
    """The mLSTM core's parameters (the reference's ``init_mlstm``)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, d_in, d_qk, h, _, _ = mlstm_dims(cfg)
        s, dt = d ** -0.5, cfg.pdtype
        self.w_q = L.param((d, d_qk), dt, device, gen, s)
        self.w_k = L.param((d, d_qk), dt, device, gen, s)
        self.w_v = L.param((d, d_in), dt, device, gen, s)
        self.w_z = L.param((d, d_in), dt, device, gen, s)   # output gate
        self.w_if = L.param((d, 2 * h), dt, device, gen, s)  # i~, f~ per head
        # forget-gate bias > 0 (remember by default), input-gate bias < 0
        self.b_if = _const([-2.0] * h + [3.0] * h, dt, device)
        self.w_out = L.param((d_in, d), dt, device, gen, d_in ** -0.5)
        self.norm_scale = L.param((d_in,), dt, device, fill=1.0)


def heads_below_model(cfg: ModelConfig, md: int) -> bool:
    """True where ranks of a model axis of ``md`` share each xLSTM head:
    the heads are fewer than the ranks and |model| a multiple of them.
    ``sharding/rules`` then split d_qk, d_in and 4d over "model" (which
    ``model.check_mesh_servable`` requires to divide) and leave ``w_if``
    and the states whole; each rank runs ``_mlstm_shared`` and every
    sLSTM head."""
    return cfg.n_heads < md and md % cfg.n_heads == 0


# one mLSTM core's weights as a mesh rank uses them (its heads)
_MLSTMW = collections.namedtuple(
    "_MLSTMW", "w_q w_k w_v w_z w_if b_if w_out norm_scale")


def _mlstm_weights(cfg: ModelConfig, p: MLSTM, mesh):
    """(this rank's head count, the core's weights as the forward uses
    them): every head and the module itself, or on a mesh the rank's
    heads.  Where ranks share each head (``heads_below_model``) the
    count is every head: ``b_if`` and, where the rules leave its 2H
    columns whole, ``w_if`` through ``copy_to_model`` (each rank's use of
    its head's gates gives them a partial gradient; split columns are
    gathered at use instead, ``_mlstm_gates``), and ``norm_scale`` cut to
    the rank's d_in block."""
    if mesh is None:
        return cfg.n_heads, p
    w_q, w_k, w_v, w_z, w_if, w_out = C.unshard(p.w_q, p.w_k, p.w_v, p.w_z,
                                                p.w_if, p.w_out)
    _, d_in, _, h_all, hd_v, hd_qk = mlstm_dims(cfg)
    if heads_below_model(cfg, mesh.size("model")):
        if w_if.shape[1] == 2 * h_all:          # not split over "model"
            w_if = C.copy_to_model(w_if)
        return h_all, _MLSTMW(w_q, w_k, w_v, w_z, w_if,
                              C.copy_to_model(p.b_if), w_out,
                              C.model_columns(p.norm_scale, w_v.shape[1]))
    h = w_q.shape[1] // hd_qk
    return h, _MLSTMW(w_q, w_k, w_v, w_z, w_if,
                      C.model_columns(p.b_if, 2 * h, groups=2), w_out,
                      C.model_columns(p.norm_scale, h * hd_v))


def _mlstm_gates(cfg: ModelConfig, p, x: torch.Tensor, h: int | None = None,
                 mesh=None):
    """Returns q, k, v (headed), log_f, log_i — all f32 except qkv — of
    ``h`` heads (default all; on a mesh the rank's).  Where ranks share
    each head (``heads_below_model``) q, k and v are the rank's columns,
    (B, S, 1, hd / s) with s ranks a head, and the gates every head's."""
    _, _, _, h_all, hd_v, hd_qk = mlstm_dims(cfg)
    h = h or h_all
    b, s, _ = x.shape
    # the reference multiplies by the scale rounded to x's dtype
    k_scale = float(torch.tensor(hd_qk ** -0.5, dtype=x.dtype))
    nh = max(p.w_q.shape[1] // hd_qk, 1)      # 1 where ranks share a head
    q = (x @ p.w_q.to(x.dtype)).reshape(b, s, nh, -1)
    k = (x @ p.w_k.to(x.dtype)).reshape(b, s, nh, -1) * k_scale
    v = (x @ p.w_v.to(x.dtype)).reshape(b, s, nh, -1)
    gates = x @ p.w_if.to(x.dtype)
    if mesh is not None and not heads_below_model(cfg, mesh.size("model")):
        gates = torch.cat(L.model_blocks(gates, 2, mesh), -1)  # its heads
    elif mesh is not None and gates.shape[-1] != 2 * h:
        gates = C.gather_for_split(gates, -1, mesh)   # every head's gates
    gates = gates.float() + p.b_if.float()
    i_pre, f_pre = gates[..., :h], gates[..., h:]
    log_i = i_pre.clamp(max=I_CLAMP)                     # (B, S, H)
    log_f = F.logsigmoid(f_pre)                          # (B, S, H), <= 0
    return q, k, v, log_f, log_i


def _mlstm_chunk(c_st, n_st, qc, kc, vc, lfc, lic, mask):
    """One chunk of the chunkwise mLSTM: returns (y (B, ck, H, hd_v),
    c', n')."""
    cum = torch.cumsum(lfc, dim=1)                       # inclusive (B,ck,H)
    total = cum[:, -1]
    qf, kf, vf = qc.float(), kc.float(), vc.float()
    # incoming-state contribution: decay_in[t] = exp(cum_t)
    decay_in = torch.exp(cum)
    num_st = torch.einsum("blhk,bhvk->blhv", qf, c_st) * decay_in[..., None]
    den_st = torch.einsum("blhk,bhk->blh", qf, n_st) * decay_in
    # within-chunk "attention": D[t,u] = exp(cum_t - cum_u + log_i_u), u <= t
    rel = cum[:, :, None, :] - cum[:, None, :, :] + lic[:, None, :, :]
    rel = torch.where(mask[None, :, :, None], rel, -1e30)  # mask BEFORE exp
    dmat = torch.exp(rel)                                # (B, l, u, H)
    scores = torch.einsum("blhk,buhk->blhu", qf, kf)
    w = scores * dmat.transpose(2, 3)                    # (B, l, H, u)
    num_in = torch.einsum("blhu,buhv->blhv", w, vf)
    den_in = w.sum(-1)
    den = (den_st + den_in).abs()
    y = (num_st + num_in) / den.clamp(min=1.0)[..., None]
    # state update: c' = exp(total) c + sum_u exp(total - cum_u + li_u) v_u k_u^T
    carry_decay = torch.exp(total[:, None] - cum + lic)  # (B, ck, H)
    vz = vf * carry_decay[..., None]
    c_new = c_st * torch.exp(total)[..., None, None] + torch.einsum(
        "buhv,buhk->bhvk", vz, kf)
    n_new = n_st * torch.exp(total)[..., None] + torch.einsum(
        "buh,buhk->bhk", carry_decay, kf)
    return y, c_new, n_new


def mlstm_fwd(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
              state: dict | None = None):
    """x: (B, S, d) -> (y, new_state).  state: {"c": (B,H,hdv,hdqk),
    "n": (B,H,hdqk)}; decode path when S == 1 and state is given.  On a
    mesh x and y are the rank's rows and the state its rows and heads."""
    mesh = manual_dp_context()[0]
    h, w = _mlstm_weights(cfg, p, mesh)
    if mesh is not None:
        x = C.copy_to_model(x)
    b, s, _ = x.shape
    _, d_in, _, _, hd_v, hd_qk = mlstm_dims(cfg)
    q, k, v, log_f, log_i = _mlstm_gates(cfg, w, x, h, mesh)
    z = x @ w.w_z.to(x.dtype)
    width = None if mesh is None else d_in
    if mesh is not None and heads_below_model(cfg, mesh.size("model")):
        y, st = _mlstm_shared(cfg, q, k, v, log_f, log_i, state, mesh)
        y = L.gated_rmsnorm(y.to(x.dtype), z, w.norm_scale, width)
        return _row_out(y @ w.w_out.to(x.dtype), mesh), st

    if state is not None and s == 1:
        y, c, n = _mlstm_step(state["c"], state["n"], q, k, v, log_f, log_i)
        y = y.reshape(b, 1, h * hd_v).to(x.dtype)
        y = L.gated_rmsnorm(y, z, w.norm_scale, width)
        return _row_out(y @ w.w_out.to(x.dtype), mesh), {"c": c, "n": n}

    # ----- chunkwise parallel (prefill) --------------------------------------
    if state is None:
        state = init_mlstm_state(cfg, b, device=x.device, n_heads=h)
    y, c_st, n_st = _scan_in_order(cfg, state["c"], state["n"], q, k, v,
                                   log_f, log_i)
    y = y.reshape(b, s, h * hd_v).to(x.dtype)
    y = L.gated_rmsnorm(y, z, w.norm_scale, width)
    return _row_out(y @ w.w_out.to(x.dtype), mesh), {"c": c_st, "n": n_st}


def _mlstm_step(c, n, q, k, v, log_f, log_i):
    """One decode step of the heads given: q, k, v (B, 1, H, .), the
    gates (B, 1, H), the state c (B, H, hd_v, hd_qk) and n (B, H, hd_qk).
    Returns (y (B, H, hd_v) f32, c', n')."""
    f = torch.exp(log_f[:, 0])                           # (B, H)
    i = torch.exp(log_i[:, 0])
    kf, vf = k[:, 0].float(), v[:, 0].float()
    vk = torch.einsum("bhv,bhk->bhvk", vf, kf)
    c = c * f[..., None, None] + vk * i[..., None, None]
    n = n * f[..., None] + kf * i[..., None]
    qf = q[:, 0].float()
    num = torch.einsum("bhvk,bhk->bhv", c, qf)
    den = torch.einsum("bhk,bhk->bh", n, qf).abs()
    return num / den.clamp(min=1.0)[..., None], c, n


def _mlstm_scan(cfg: ModelConfig, c_st, n_st, q, k, v, log_f, log_i):
    """The chunkwise run over S steps (a multiple of the chunk) of the
    heads given, from the state (c, n).  Returns (y (B, S, H, hd_v) f32,
    c', n')."""
    b, s = q.shape[:2]
    ck = min(cfg.ssm.chunk, s)
    assert s % ck == 0, (s, ck)
    nc = s // ck
    chunks = [t.reshape(b, nc, ck, *t.shape[2:]).transpose(0, 1)
              for t in (q, k, v, log_f, log_i)]
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                 device=q.device))
    ys = []
    for ci in range(nc):
        y, c_st, n_st = _mlstm_chunk(c_st, n_st,
                                     *(t[ci] for t in chunks), mask)
        ys.append(y)
    return torch.stack(ys, 1).reshape(b, s, *ys[0].shape[2:]), c_st, n_st


def _scan_in_order(cfg: ModelConfig, c_st, n_st, q, k, v, log_f, log_i):
    """``_mlstm_scan`` over the rank's positions; under a sequence split
    each slice from the state the one before ends with
    (``sharding/sequence.in_order``; the returned state the whole
    sequence's)."""
    def core(q, k, v, log_f, log_i, c, n):
        y, c, n = _mlstm_scan(cfg, c, n, q, k, v, log_f, log_i)
        return y, (c, n)
    y, (c_st, n_st) = in_order(core, (q, k, v, log_f, log_i), (c_st, n_st),
                               q.shape[1])
    return y, c_st, n_st


def _mlstm_shared(cfg: ModelConfig, q, k, v, log_f, log_i, state, mesh):
    """One rank's mLSTM where s = |model| / H ranks share each head
    (``heads_below_model``): its q, k and v columns (B, S, 1, hd / s) are
    1 / s of head r // s's qk and v dims, its gates every head's, and the
    state (c, n) whole on every rank (the rules replicate it).  Returns
    (the rank's block of y (B, S, d_in / |model|) in f32, the whole state).

    The recurrence splits exactly by v rows, but the den |n·q| and the
    chunk's scores q·k need a head's whole qk dims.  Decode gathers q, k
    and v whole over "model" in one collective (the replicated state's
    update needs every head's k and v on every rank) and steps every
    head as one device.  A chunkwise run gathers q and k (``gather_for_
    split``, whose backward reduce-scatters) and runs head r // s on the
    rank's v rows; the final state's rows are gathered over "model" once
    (no gradient: nothing trains through it).  Every rank's state has
    the same bits.  Bytes one rank sends a layer (``collectives.WIRE``,
    PERF.md; ``a`` bytes an element): decode (|model| - 1) B (2 d_qk +
    d_in) a / |model|, where gathering the state's rows instead would
    send (|model| - 1) B d_in hd_qk 4 / |model|; chunkwise (|model| - 1)
    B (2 S d_qk a / |model| + 4 hd_qk (d_in / |model| + 1)), where
    gathering v too and running every head (as decode) would send
    (|model| - 1) B S (2 d_qk + d_in) a / |model|."""
    md, r = mesh.size("model"), C.model_index(mesh)
    _, d_in, d_qk, h, hd_v, hd_qk = mlstm_dims(cfg)
    sh = md // h
    hh = r // sh
    b, sl = q.shape[:2]
    if state is not None and sl == 1:
        qkv = C.gather_for_split(torch.cat([t.reshape(b, 1, -1)
                                            for t in (q, k, v)], -1),
                                 -1, mesh).reshape(b, 1, md, -1)
        wq, wv = d_qk // md, d_in // md
        q, k, v = (qkv[..., a:a + n].reshape(b, 1, h, -1)
                   for a, n in ((0, wq), (wq, wq), (2 * wq, wv)))
        y, c, n = _mlstm_step(state["c"], state["n"], q, k, v, log_f,
                              log_i)
        y = y.reshape(b, 1, d_in)[..., r * d_in // md:(r + 1) * d_in // md]
        return y, {"c": c, "n": n}
    # chunkwise: head hh's whole q and k, the rank's v rows of it
    qk = C.gather_for_split(torch.cat([q, k], -1).reshape(b, sl, -1), -1,
                            mesh).reshape(b, sl, h, sh, 2, -1)[:, :, hh]
    q, k = (qk[..., j, :].reshape(b, sl, 1, hd_qk) for j in (0, 1))
    rows = slice((r % sh) * hd_v // sh, (r % sh + 1) * hd_v // sh)
    if state is None:
        state = init_mlstm_state(cfg, b, device=q.device)
    y, c_st, n_st = _scan_in_order(
        cfg, state["c"][:, hh:hh + 1, rows], state["n"][:, hh:hh + 1], q, k,
        v, log_f[..., hh:hh + 1], log_i[..., hh:hh + 1])
    y = y.reshape(b, sl, -1)
    # the whole state: every rank's rows of its head's c, and each head's
    # n from the first of its ranks (its s ranks hold the same n)
    with torch.no_grad():
        part = torch.cat([c_st.reshape(b, -1), n_st.reshape(b, -1)], -1)
        every = C.all_gather(part.detach()[None], "model", 0, mesh)
        nv = c_st[0].numel()
        c = every[..., :nv].reshape(h, sh, b, hd_v // sh, hd_qk) \
            .permute(2, 0, 1, 3, 4).reshape(b, h, hd_v, hd_qk)
        n = every[::sh, :, nv:].permute(1, 0, 2)
    return y, {"c": c.contiguous(), "n": n.contiguous()}


def _row_out(y: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel projection's output: on a mesh the partial sums
    all-reduced over "model"."""
    return y if mesh is None else C.all_reduce_sum(y, "model")


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device,
                     n_heads: int | None = None):
    """Zero states of ``n_heads`` heads (default all)."""
    _, _, _, h, hd_v, hd_qk = mlstm_dims(cfg)
    h = n_heads or h
    return {"c": torch.zeros((batch, h, hd_v, hd_qk), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, hd_qk), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_dims(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    return d, h, d // h


def slstm_d_up(cfg: ModelConfig) -> int:
    """The post-FFN's width: 4/3 of d_model, rounded up to 128."""
    return (4 * cfg.d_model // 3 + 127) // 128 * 128


class SLSTM(nn.Module):
    """The sLSTM core's parameters (the reference's ``init_slstm``)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, h, hd = slstm_dims(cfg)
        s, dt = d ** -0.5, cfg.pdtype
        d_up = slstm_d_up(cfg)                          # post-FFN at ratio 4/3
        # input projections for gates z, i, f, o (fused)
        self.w_x = L.param((d, 4 * d), dt, device, gen, s)
        # block-diagonal recurrent weights, per head: (H, hd, 4*hd)
        self.w_h = L.param((h, hd, 4 * hd), dt, device, gen, hd ** -0.5)
        self.b = _const([0.0] * d + [-2.0] * d + [3.0] * d + [0.0] * d, dt,
                        device)
        self.w_up = L.param((d, 2 * d_up), dt, device, gen, s)
        self.w_down = L.param((d_up, d), dt, device, gen, d_up ** -0.5)


def slstm_fwd(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
              state: dict | None = None):
    """x: (B, S, d) -> (y, new_state); the S-step recurrence is one
    ``slstm_scan`` call: on the GPU one cooperative launch that holds
    ``w_h`` in shared memory across its CTAs for all S steps, with one
    barrier per step among the CTAs of a head.  When autograd records, the
    call goes through ``slstm_scan_trainable``: the same launch forward, a
    recompute of the plain scan in the backward.  On a mesh each rank
    runs the recurrence on its heads (module docstring); under a sequence
    split on its slice of the positions, from the state the slice before
    ends with (``sharding/sequence.in_order``: the launch runs in the
    forward, and in the backward again before the plain recompute)."""
    mesh = manual_dp_context()[0]
    b, s, d = x.shape
    _, h, hd = slstm_dims(cfg)
    if mesh is None:
        w_x, w_h, w_up, w_down = p.w_x, p.w_h, p.w_up, p.w_down
        xg = x @ w_x.to(x.dtype) + p.b.to(x.dtype)          # (B, S, 4d)
    elif heads_below_model(cfg, mesh.size("model")):
        # every head on every rank: the gates and w_h gathered whole (the
        # bias added to the rank's columns first), the state whole
        w_x, w_h, w_up, w_down = C.unshard(p.w_x, p.w_h, p.w_up, p.w_down)
        xg = C.gather_for_split(
            C.copy_to_model(x) @ w_x.to(x.dtype)
            + C.model_columns(p.b, w_x.shape[1]).to(x.dtype), -1, mesh)
        w_h = C.gather_for_split(w_h, 2, mesh)
    else:
        w_x, w_h, w_up, w_down = C.unshard(p.w_x, p.w_h, p.w_up, p.w_down)
        h //= mesh.size("model")
        # the four gates of the rank's heads, and their recurrent weights
        xg = torch.cat(L.model_blocks(C.copy_to_model(x) @ w_x.to(x.dtype),
                                      4, mesh), -1) \
            + C.model_columns(p.b, 4 * h * hd, groups=4).to(x.dtype)
        me = C.model_index(mesh)
        w_h = C.gather_for_split(w_h, 2, mesh)[me * h:(me + 1) * h]
    # the kernel's (S, B, H, 4*hd) layout, gates [z|i|f|o] per head
    xg = xg.reshape(b, s, 4, h, hd).permute(1, 0, 3, 2, 4) \
        .reshape(s, b, h, 4 * hd).float().contiguous()
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device, n_heads=h)
    wh = w_h.to(x.dtype).contiguous()

    def core(xg, wh, *st):
        scan = slstm_scan_trainable if torch.is_grad_enabled() and (
            xg.requires_grad or wh.requires_grad) else slstm_scan
        return scan(xg, wh, *st)
    ys, (hf, cf, nf, mf) = in_order(
        core, (xg, wh),
        tuple(state[k].contiguous() for k in ("h", "c", "n", "m")), s)
    y = ys.permute(1, 0, 2, 3).reshape(b, s, h * hd).to(x.dtype)
    # post up/down FFN (GeGLU at ratio ~4/3, per the sLSTM block design);
    # the reference's gelu is the tanh approximation
    if mesh is None:
        u, g = (y @ w_up.to(x.dtype)).chunk(2, dim=-1)
    else:               # y whole, then the rank's share of u and of g
        if h < cfg.n_heads:
            y = C.gather_for_split(y, -1, mesh)
        u, g = L.model_blocks(y @ w_up.to(x.dtype), 2, mesh)
    y = _row_out((u * F.gelu(g, approximate="tanh")) @ w_down.to(x.dtype),
                 mesh)
    return y, {"h": hf, "c": cf, "n": nf, "m": mf}


def init_slstm_state(cfg: ModelConfig, batch: int, *, device,
                     n_heads: int | None = None):
    """Zero states (m at -1e30) of ``n_heads`` heads (default all)."""
    _, h, hd = slstm_dims(cfg)
    h = n_heads or h
    z = torch.zeros((batch, h, hd), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full((batch, h, hd), -1e30, dtype=torch.float32,
                            device=device)}
