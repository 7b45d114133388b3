"""Plain oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

Shapes are the UNPADDED logical shapes; the ops.py wrappers pad and align
before calling the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_forward_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused 2-layer MLP: tanh(x @ w1 + b1) @ w2 + b2.

    x: (T, d_in); w1: (d_in, d_h); w2: (d_h, d_out).  Sums in f32 whatever
    the input dtype, and ``h`` is not rounded (the kernel rounds it)."""
    h = torch.tanh(x.float() @ w1.float() + b1.float())
    y = h @ w2.float() + b2.float()
    return y.to(x.dtype)


def switched_mlp_ref(x: torch.Tensor, cls: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """Per-row approximator selection (the MCMA weight switch).

    x: (T, d_in); cls: (T,) int32 in [0, n_approx);
    w1: (n, d_in, d_h); b1: (n, d_h); w2: (n, d_h, d_out); b2: (n, d_out).
    Row t is evaluated under approximator cls[t]'s weights, in f32.
    """
    c = cls.long()
    h = torch.tanh(torch.einsum("ti,tih->th", x.float(), w1[c].float())
                   + b1[c].float())
    y = torch.einsum("th,tho->to", h, w2[c].float()) + b2[c].float()
    return y.to(x.dtype)


def slstm_scan_ref(xg, wh, h0, c0, n0, m0, clamp=8.0):
    """Oracle for the sLSTM recurrence kernel (kernels/slstm_scan.py).

    xg: (S, B, H, 4*hd) f32 gate pre-activations (order [z|i|f|o] per head);
    wh: (H, hd, 4*hd); states: (B, H, hd) f32.  ``h`` enters the recurrent
    product in f32 (the kernel rounds it to ``wh.dtype`` first).  Float64
    inputs run the recurrence in float64 (a yardstick for gradients)."""
    s, b, h, hd4 = xg.shape
    assert hd4 % 4 == 0, (
        f"xg last dim must stack the 4 gate pre-activations, got {hd4}")
    hd = hd4 // 4
    w = wh.to(torch.promote_types(xg.dtype, torch.float32))
    hp, cp, np_, mp = h0, c0, n0, m0
    ys = []
    for t in range(s):
        g = xg[t] + torch.einsum("bhi,hio->bho", hp, w)
        gz, gi, gf, go = (g[..., :hd], g[..., hd:2 * hd],
                          g[..., 2 * hd:3 * hd], g[..., 3 * hd:])
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        log_f = F.logsigmoid(gf)
        i_pre = torch.clamp(gi, max=clamp)
        m = torch.maximum(log_f + mp, i_pre)
        i_s = torch.exp(i_pre - m)
        f_s = torch.exp(log_f + mp - m)
        cp = f_s * cp + i_s * z
        np_ = f_s * np_ + i_s
        hp = o * cp / torch.clamp(np_, min=1e-6)
        mp = m
        ys.append(hp)
    return torch.stack(ys), (hp, cp, np_, mp)
