"""Iterative baseline [Xu et al., DAC'17] (counterpart of
``repro/core/iterative.py``):

Alternate: retrain the approximator on the data the classifier currently
accepts (and that is truly under the bound — the "AC" agreement set of
paper §III-A), then regenerate labels from the approximator and retrain the
classifier.  Error shrinks, but so does the accepted set — motivating MCMA.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.core import quality
from repro_torch.core.mlp import (balanced_weights, init_mlp, mlp_logits,
                                  train_mlp)
from repro_torch.core.onepass import BinaryPair

if TYPE_CHECKING:  # avoid circular import (apps imports core.mlp)
    from repro_torch.apps.registry import App


def train_iterative(app: "App", gen: torch.Generator, x, y, *,
                    iters: int = 5, epochs: int = 1500, lr: float = 1e-2,
                    selection: str = "AC") -> BinaryPair:
    """``selection``: "AC" (paper default), "C" (classifier-only, clusters —
    used inside MCCA), or "A" (error-only, scatters; Fig. 2b).  ``gen``
    draws the approximator's init, then the classifier's."""
    aspec, cspec = app.approx_spec, app.cls_spec(2)
    a = init_mlp(gen, aspec)
    c = init_mlp(gen, cspec)
    w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        a = train_mlp(a, x, y, aspec, weights=w, epochs=epochs, lr=lr)
        err = quality.approx_errors(app, a, aspec, x, y)
        labels = (err <= app.error_bound).to(torch.int32)
        c = train_mlp(c, x, labels, cspec, loss="xent", epochs=epochs, lr=lr,
                      weights=balanced_weights(labels, 2))
        accept = torch.argmax(mlp_logits(c, x, cspec), -1) == 1
        if selection == "AC":
            w = (accept & (err <= app.error_bound)).to(torch.float32)
        elif selection == "C":
            w = accept.to(torch.float32)
        else:  # "A"
            w = (err <= app.error_bound).to(torch.float32)
        # Never let the territory collapse to nothing (keeps training defined).
        w = torch.where(w.sum() < 8, torch.ones_like(w), w)
    return BinaryPair(app, a, c)
