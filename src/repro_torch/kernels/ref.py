"""Plain oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

Shapes are the UNPADDED logical shapes; the ops.py wrappers pad and align
before calling the kernels.
"""
from __future__ import annotations

import torch


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
