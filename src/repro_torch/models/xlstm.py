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
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models import layers as L

I_CLAMP = 8.0  # clamp on the exponential input gate pre-activation


def _const(values, dtype, device) -> nn.Parameter:
    """A frozen parameter holding fixed initial ``values``."""
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


def _mlstm_gates(cfg: ModelConfig, p: MLSTM, x: torch.Tensor):
    """Returns q, k, v (headed), log_f, log_i — all f32 except qkv."""
    _, _, _, h, hd_v, hd_qk = mlstm_dims(cfg)
    b, s, _ = x.shape
    # the reference multiplies by the scale rounded to x's dtype
    k_scale = float(torch.tensor(hd_qk ** -0.5, dtype=x.dtype))
    q = (x @ p.w_q.to(x.dtype)).reshape(b, s, h, hd_qk)
    k = (x @ p.w_k.to(x.dtype)).reshape(b, s, h, hd_qk) * k_scale
    v = (x @ p.w_v.to(x.dtype)).reshape(b, s, h, hd_v)
    gates = (x @ p.w_if.to(x.dtype)).float() + p.b_if.float()
    i_pre, f_pre = gates[..., :h], gates[..., h:]
    log_i = i_pre.clamp(max=I_CLAMP)                     # (B, S, H)
    log_f = F.logsigmoid(f_pre)                          # (B, S, H), <= 0
    return q, k, v, log_f, log_i


def _gated_rmsnorm(x, z, scale):
    xf = (x * F.silu(z)).float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (xf * r).to(x.dtype) * scale.to(x.dtype)


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
    "n": (B,H,hdqk)}; decode path when S == 1 and state is given."""
    b, s, _ = x.shape
    _, d_in, _, h, hd_v, hd_qk = mlstm_dims(cfg)
    q, k, v, log_f, log_i = _mlstm_gates(cfg, p, x)
    z = x @ p.w_z.to(x.dtype)

    if state is not None and s == 1:
        c, n = state["c"], state["n"]
        f = torch.exp(log_f[:, 0])                       # (B, H)
        i = torch.exp(log_i[:, 0])
        kf, vf = k[:, 0].float(), v[:, 0].float()
        vk = torch.einsum("bhv,bhk->bhvk", vf, kf)
        c = c * f[..., None, None] + vk * i[..., None, None]
        n = n * f[..., None] + kf * i[..., None]
        qf = q[:, 0].float()
        num = torch.einsum("bhvk,bhk->bhv", c, qf)
        den = torch.einsum("bhk,bhk->bh", n, qf).abs()
        y = num / den.clamp(min=1.0)[..., None]
        y = y.reshape(b, 1, d_in).to(x.dtype)
        y = _gated_rmsnorm(y, z, p.norm_scale)
        return y @ p.w_out.to(x.dtype), {"c": c, "n": n}

    # ----- chunkwise parallel (prefill) --------------------------------------
    ck = min(cfg.ssm.chunk, s)
    assert s % ck == 0, (s, ck)
    nc = s // ck
    chunks = [t.reshape(b, nc, ck, *t.shape[2:]).transpose(0, 1)
              for t in (q, k, v, log_f, log_i)]
    if state is None:
        state = init_mlstm_state(cfg, b, device=x.device)
    c_st, n_st = state["c"], state["n"]
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for ci in range(nc):
        y, c_st, n_st = _mlstm_chunk(c_st, n_st,
                                     *(t[ci] for t in chunks), mask)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, s, d_in).to(x.dtype)
    y = _gated_rmsnorm(y, z, p.norm_scale)
    return y @ p.w_out.to(x.dtype), {"c": c_st, "n": n_st}


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device):
    _, _, _, h, hd_v, hd_qk = mlstm_dims(cfg)
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


class SLSTM(nn.Module):
    """The sLSTM core's parameters (the reference's ``init_slstm``)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, h, hd = slstm_dims(cfg)
        s, dt = d ** -0.5, cfg.pdtype
        d_up = (4 * d // 3 + 127) // 128 * 128          # post-FFN at ratio 4/3
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
    barrier per step among the CTAs of a head."""
    b, s, d = x.shape
    _, h, hd = slstm_dims(cfg)
    xg = x @ p.w_x.to(x.dtype) + p.b.to(x.dtype)        # (B, S, 4d)
    # the kernel's (S, B, H, 4*hd) layout, gates [z|i|f|o] per head
    xg = xg.reshape(b, s, 4, h, hd).permute(1, 0, 3, 2, 4) \
        .reshape(s, b, h, 4 * hd).float().contiguous()
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device)
    ys, (hf, cf, nf, mf) = slstm_scan(
        xg, p.w_h.to(x.dtype).contiguous(),
        *(state[k].contiguous() for k in ("h", "c", "n", "m")))
    y = ys.permute(1, 0, 2, 3).reshape(b, s, d).to(x.dtype)
    # post up/down FFN (GeGLU at ratio ~4/3, per the sLSTM block design);
    # the reference's gelu is the tanh approximation
    u, g = (y @ p.w_up.to(x.dtype)).chunk(2, dim=-1)
    y = (u * F.gelu(g, approximate="tanh")) @ p.w_down.to(x.dtype)
    return y, {"h": hf, "c": cf, "n": nf, "m": mf}


def init_slstm_state(cfg: ModelConfig, batch: int, *, device):
    _, h, hd = slstm_dims(cfg)
    z = torch.zeros((batch, h, hd), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full((batch, h, hd), -1e30, dtype=torch.float32,
                            device=device)}
