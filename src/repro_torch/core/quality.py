"""Quality control: per-sample approximation error, safe-to-approximate
labels, and the invocation/error/confusion metrics of Fig. 7 and Fig. 11
(counterpart of ``repro/core/quality.py``).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.core.mlp import MLPSpec, Params, apply_mlp

if TYPE_CHECKING:  # avoid circular import (apps imports core.mlp)
    from repro_torch.apps.registry import App


def per_sample_error(app: "App", y_pred: torch.Tensor,
                     y_true: torch.Tensor) -> torch.Tensor:
    """Per-sample error, comparable against ``app.error_bound``.

    * ``rmse_rel``: per-sample RMSE over output dims, normalized by the
      GLOBAL output RMS of the batch (a per-sample denominator would make
      near-zero outputs unapproximable by definition).
    * ``class``: 0/1 misclassification (jmeint).
    """
    if app.err_kind == "class":
        return (torch.argmax(y_pred, -1) != torch.argmax(y_true, -1)
                ).to(torch.float32)
    se = ((y_pred - y_true) ** 2).mean(-1)
    denom = torch.sqrt((y_true ** 2).mean())
    return torch.sqrt(se) / torch.clamp(denom, min=1e-6)


def approx_errors(app: "App", params: Params, spec: MLPSpec, x,
                  y) -> torch.Tensor:
    return per_sample_error(app, apply_mlp(params, x, spec), y)


@dataclasses.dataclass
class Metrics:
    """Runtime metrics for one method on one app (test set)."""

    invocation: float        # fraction of inputs dispatched to an approximator
    err_norm: float          # mean error of dispatched samples / error bound
    true_invocation: float   # AC fraction (dispatched AND truly safe)
    recall: float            # AC / (AC + AnC) — how much safe data we salvage
    false_neg: float         # AnC: safe data abandoned to the CPU
    false_pos: float         # nAC: unsafe data wrongly dispatched
    dispatch_frac: list      # per-approximator share of dispatched inputs

    def row(self) -> str:
        return (f"inv={self.invocation:.3f} err/bound={self.err_norm:.3f} "
                f"AC={self.true_invocation:.3f} recall={self.recall:.3f} "
                f"AnC={self.false_neg:.3f} nAC={self.false_pos:.3f}")


def _mean(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.float32).mean()


def confusion_metrics(app: "App", dispatched: torch.Tensor,
                      err_dispatched: torch.Tensor, err_best: torch.Tensor,
                      n_approx: int,
                      choice: torch.Tensor | None = None) -> Metrics:
    """Build Metrics from runtime decisions.

    ``dispatched``: bool (n,) — classifier sent the input to an approximator.
    ``err_dispatched``: error of the *chosen* approximator per sample.
    ``err_best``: error of the best available approximator per sample
    (defines ground-truth "safe" = any approximator could have fit it).
    """
    bound = app.error_bound
    safe = err_best <= bound
    inv = _mean(dispatched)
    ac = _mean(dispatched & (err_dispatched <= bound))
    anc = _mean(~dispatched & safe)
    nac = _mean(dispatched & (err_dispatched > bound))
    denom = torch.clamp(ac + anc, min=1e-9)
    n_disp = dispatched.sum().to(torch.float32)
    err_n = torch.where(dispatched, err_dispatched, 0.0).sum() \
        / torch.clamp(n_disp, min=1.0) / bound
    if choice is None:
        frac = [float(inv)]
    else:
        tot = torch.clamp(n_disp, min=1.0)
        frac = [float((dispatched & (choice == i)).sum().to(torch.float32)
                      / tot) for i in range(n_approx)]
    return Metrics(float(inv), float(err_n), float(ac), float(ac / denom),
                   float(anc), float(nac), frac)
