"""One-pass baseline [Mahajan et al., ISCA'16] (counterpart of
``repro/core/onepass.py``):

Train the approximator once on ALL data; derive safe/unsafe labels from its
errors; train a binary classifier on those labels.  No iteration — the A<->C
correlation is ignored (paper §II-B).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.core import quality
from repro_torch.core.mlp import (Params, balanced_weights, init_mlp,
                                  mlp_logits, train_mlp)

if TYPE_CHECKING:  # avoid circular import (apps imports core.mlp)
    from repro_torch.apps.registry import App


@dataclasses.dataclass
class BinaryPair:
    """A trained (approximator, binary classifier) pair."""

    app: "App"
    a_params: Params
    c_params: Params

    def dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """True where the classifier accepts the input (class 1 = safe)."""
        logits = mlp_logits(self.c_params, x, self.app.cls_spec(2))
        return torch.argmax(logits, -1) == 1

    def evaluate(self, x: torch.Tensor, y: torch.Tensor) -> quality.Metrics:
        err = quality.approx_errors(self.app, self.a_params,
                                    self.app.approx_spec, x, y)
        return quality.confusion_metrics(self.app, self.dispatch(x), err,
                                         err, 1)


def train_one_pass(app: "App", gen: torch.Generator, x, y, *,
                   epochs: int = 1500, lr: float = 1e-2) -> BinaryPair:
    """``gen`` draws the approximator's init, then the classifier's."""
    a0 = init_mlp(gen, app.approx_spec)
    a = train_mlp(a0, x, y, app.approx_spec, epochs=epochs, lr=lr)
    err = quality.approx_errors(app, a, app.approx_spec, x, y)
    labels = (err <= app.error_bound).to(torch.int32)
    c0 = init_mlp(gen, app.cls_spec(2))
    c = train_mlp(c0, x, labels, app.cls_spec(2), loss="xent", epochs=epochs,
                  lr=lr, weights=balanced_weights(labels, 2))
    return BinaryPair(app, a, c)
