"""MCCA — Multiple Cascaded Classifiers and Approximators (paper §III-B;
counterpart of ``repro/core/mcca.py``).

Pair i+1 is trained on the residual inputs rejected by classifiers 1..i
(category "C" selection inside each pair's iterative loop, per the paper).
The cascade stops when a pair "cannot converge" — operationalized as the
residual set dropping below ``min_frac`` of the data or ``max_pairs``.

Runtime is cascaded: the first classifier that accepts wins; inputs rejected
by every classifier go to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.core import quality
from repro_torch.core.mlp import (balanced_weights, init_mlp, mlp_logits,
                                  train_mlp)

if TYPE_CHECKING:  # avoid circular import (apps imports core.mlp)
    from repro_torch.apps.registry import App


@dataclasses.dataclass
class MCCA:
    app: "App"
    pairs: list  # list of (a_params, c_params)

    def dispatch(self, x: torch.Tensor):
        """Returns (dispatched mask, chosen pair index; -1 = CPU)."""
        cspec = self.app.cls_spec(2)
        choice = torch.full((x.shape[0],), -1, dtype=torch.int32,
                            device=x.device)
        for i, (_, c) in enumerate(self.pairs):
            accept = torch.argmax(mlp_logits(c, x, cspec), -1) == 1
            choice = torch.where((choice < 0) & accept, i, choice)
        return choice >= 0, choice

    def evaluate(self, x: torch.Tensor, y: torch.Tensor) -> quality.Metrics:
        aspec = self.app.approx_spec
        errs = torch.stack([quality.approx_errors(self.app, a, aspec, x, y)
                            for a, _ in self.pairs])        # (n_pairs, n)
        dispatched, choice = self.dispatch(x)
        err_chosen = errs[choice.clamp(min=0).long(),
                          torch.arange(x.shape[0], device=x.device)]
        return quality.confusion_metrics(self.app, dispatched, err_chosen,
                                         errs.amin(0), len(self.pairs),
                                         choice)

    def classifiers_consulted(self, x: torch.Tensor) -> torch.Tensor:
        """Mean number of classifier inferences per input (MCCA's serial
        cost)."""
        _, choice = self.dispatch(x)
        n = len(self.pairs)
        return torch.where(choice >= 0, choice + 1, n).to(
            torch.float32).mean()


def train_mcca(app: "App", gen: torch.Generator, x, y, *, max_pairs: int = 3,
               iters: int = 2, epochs: int = 1500, lr: float = 1e-2,
               min_frac: float = 0.05) -> MCCA:
    """``gen`` draws, pair by pair, the approximator's init, then the
    classifier's."""
    aspec, cspec = app.approx_spec, app.cls_spec(2)
    pairs = []
    residual = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(max_pairs):
        if float(residual.mean()) < min_frac:
            break  # cascade "cannot converge" on too little data
        a, c = init_mlp(gen, aspec), init_mlp(gen, cspec)
        w = residual
        for _ in range(iters):
            a = train_mlp(a, x, y, aspec, weights=w, epochs=epochs, lr=lr)
            err = quality.approx_errors(app, a, aspec, x, y)
            labels = ((err <= app.error_bound) & (residual > 0)).to(
                torch.int32)
            c = train_mlp(c, x, labels, cspec, loss="xent",
                          weights=residual * balanced_weights(labels, 2),
                          epochs=epochs, lr=lr)
            accept = torch.argmax(mlp_logits(c, x, cspec), -1) == 1
            # category "C" selection (paper: clusters, easier to separate)
            w = accept.to(torch.float32) * residual
            w = torch.where(w.sum() < 8, residual, w)
        pairs.append((a, c))
        accept = torch.argmax(mlp_logits(c, x, cspec), -1) == 1
        residual = residual * (~accept).to(torch.float32)
    return MCCA(app, pairs)
