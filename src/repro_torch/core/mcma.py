"""MCMA — Multiclass-Classifier and Multiple Approximators (paper §III-C;
counterpart of ``repro/core/mcma.py``).

One (n+1)-way classifier dispatches each input either to the approximator
predicted safe (classes 0..n-1) or to the CPU (class n = "nC").  Two
co-training data-allocation mechanisms:

* complementary — approximators are initialized SERIALLY on residual data
  (AdaBoost-flavored); iteration labels are produced by the FIRST
  approximator that fits each sample under the bound.
* competitive — all approximators train on ALL data from diversified
  inits/hyper-params; the label is the argmin-error approximator (if under
  the bound, else nC).

After initialization both schemes iterate: train the multiclass classifier
on the labels, re-partition the input space by the classifier's prediction
(each approximator's "territory"), retrain each approximator on its
territory, regenerate labels.  Invocation history per iteration reproduces
Fig. 9.  Class ids and labels are int32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from repro_torch.core import quality
from repro_torch.core.mlp import (balanced_weights, init_mlp, mlp_logits,
                                  train_mlp)

if TYPE_CHECKING:  # avoid circular import (apps imports core.mlp)
    from repro_torch.apps.registry import App


@dataclasses.dataclass
class MCMA:
    app: "App"
    a_params: list          # n approximator param lists (identical topology)
    c_params: object        # multiclass classifier params
    history: list           # per-iteration invocation on the training set
    scheme: str

    @property
    def n_approx(self) -> int:
        return len(self.a_params)

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) int32 class per input; == n_approx means nC (CPU)."""
        cspec = self.app.cls_spec(self.n_approx + 1)
        return torch.argmax(mlp_logits(self.c_params, x, cspec), -1).to(
            torch.int32)

    def approximator_errors(self, x: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
        aspec = self.app.approx_spec
        return torch.stack([quality.approx_errors(self.app, a, aspec, x, y)
                            for a in self.a_params])  # (n_approx, n)

    def evaluate(self, x: torch.Tensor, y: torch.Tensor) -> quality.Metrics:
        errs = self.approximator_errors(x, y)
        cls = self.classify(x)
        dispatched = cls < self.n_approx
        err_chosen = errs[cls.clamp(max=self.n_approx - 1).long(),
                          torch.arange(x.shape[0], device=x.device)]
        return quality.confusion_metrics(self.app, dispatched, err_chosen,
                                         errs.amin(0), self.n_approx, cls)


def _labels_complementary(errs: torch.Tensor, bound: float,
                          prev: torch.Tensor | None = None) -> torch.Tensor:
    """First approximator under the bound wins; else nC (= n_approx)."""
    n_approx = errs.shape[0]
    safe = errs <= bound                                    # (n_approx, n)
    # the first True (0 if none): argmax refuses bool, and returns the
    # first maximum as JAX's does
    first = torch.argmax(safe.to(torch.int32), dim=0)
    any_safe = safe.any(dim=0)
    return torch.where(any_safe, first, n_approx).to(torch.int32)


def _labels_competitive(errs: torch.Tensor, bound: float,
                        prev: torch.Tensor | None = None) -> torch.Tensor:
    """Lowest-error approximator wins if under the bound; else nC.

    With ``prev`` labels, ties are sticky (hysteresis): a sample only
    changes owner when the challenger beats the incumbent by 20% of the
    bound.  The ADJUSTED minimum is what is compared with the bound, as in
    the reference.
    """
    n_approx = errs.shape[0]
    if prev is not None:
        owner = F.one_hot(prev.long(), n_approx + 1).T[:n_approx].to(
            errs.dtype)                                     # (n_approx, n)
        errs = errs - 0.2 * bound * owner
    best = torch.argmin(errs, dim=0)
    return torch.where(errs.amin(0) <= bound, best, n_approx).to(torch.int32)


def _co_train(app, gen, x, y, a_params, n_classes, scheme, iters, epochs,
              lr):
    """The co-training loop shared by ``train_mcma`` and ``train_library``
    (the reference writes it out in both): classifier, territories,
    retrained approximators, labels, ``iters`` times."""
    aspec = app.approx_spec
    cspec = app.cls_spec(n_classes + 1)
    label_fn = _labels_complementary if scheme == "complementary" \
        else _labels_competitive
    c = init_mlp(gen, cspec)
    history = []
    labels = None
    for it in range(iters):
        errs = torch.stack([quality.approx_errors(app, a, aspec, x, y)
                            for a in a_params])
        labels = label_fn(errs, app.error_bound, labels)
        c = train_mlp(c, x, labels, cspec, loss="xent", epochs=epochs, lr=lr,
                      weights=balanced_weights(labels, n_classes + 1))
        pred = torch.argmax(mlp_logits(c, x, cspec), -1)
        history.append(float((pred < n_classes).to(torch.float32).mean()))
        if it == iters - 1:
            break
        # The classifier partitions the input space into n+1 territories
        # and each approximator retrains on its own territory.  A sample
        # also keeps a small weight with its *current* owner (err under
        # bound) so a noisy classifier round cannot erase an approximator's
        # competence.
        new_params = []
        for i, a in enumerate(a_params):
            w = ((pred == i).to(torch.float32)
                 + 0.25 * (errs[i] <= app.error_bound).to(torch.float32))
            w = torch.where(w.sum() < 8, 0.05 * torch.ones_like(w), w)
            new_params.append(train_mlp(a, x, y, aspec, weights=w,
                                        epochs=epochs, lr=lr))
        a_params = new_params
    return MCMA(app, a_params, c, history, scheme)


def train_mcma(app: "App", gen: torch.Generator, x, y, *, n_approx: int = 3,
               scheme: str = "competitive", iters: int = 5,
               epochs: int = 1500, lr: float = 1e-2) -> MCMA:
    """``gen`` draws the approximators' inits in order, then the
    classifier's."""
    assert scheme in ("competitive", "complementary")
    aspec = app.approx_spec

    # ----- initialization pass ---------------------------------------------
    a_params = []
    if scheme == "complementary":
        residual = torch.ones(x.shape[0], dtype=torch.float32,
                              device=x.device)
        for _ in range(n_approx):
            a = init_mlp(gen, aspec)
            a = train_mlp(a, x, y, aspec, weights=residual, epochs=epochs,
                          lr=lr)
            err = quality.approx_errors(app, a, aspec, x, y)
            residual = residual * (err > app.error_bound).to(torch.float32)
            residual = torch.where(residual.sum() < 8,
                                   torch.ones_like(residual) * 0.05, residual)
            a_params.append(a)
    else:  # competitive: diversified hyper-params reach different minima
        for i in range(n_approx):
            a = init_mlp(gen, aspec, scale=0.3 * (i + 1))
            a = train_mlp(a, x, y, aspec, epochs=epochs,
                          lr=lr * (0.5 + 0.5 * i))
            a_params.append(a)

    # ----- iterative co-training -------------------------------------------
    return _co_train(app, gen, x, y, a_params, n_approx, scheme, iters,
                     epochs, lr)


def _centroid_indices(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """``k`` distinct row indices drawn from ``gen`` (the k-means seeds;
    the reference draws ``jax.random.choice(key, n, (k,), replace=False)``,
    a test can hand both packages the same indices through this)."""
    return torch.randperm(n, generator=gen, device=gen.device)[:k]


def _error_clusters(gen: torch.Generator, x: torch.Tensor, err: torch.Tensor,
                    k: int, iters: int = 10) -> torch.Tensor:
    """K-means partition over (inputs, probe-error) features.

    Samples a single global fit serves BADLY cluster together (the error
    coordinate dominates exactly where the probe struggles), so the
    specialists a residency deployment needs for rare-but-hard regions
    exist from round 0.  The standard deviations are population ones
    (ddof 0), as JAX's.  Returns the (n,) int32 cluster assignment."""
    xs = (x - x.mean(0)) / torch.clamp(x.std(0, correction=0), min=1e-6)
    es = (err - err.mean()) / torch.clamp(err.std(correction=0), min=1e-6)
    z = torch.cat([xs, 2.0 * es[:, None]], -1)
    mu = z[_centroid_indices(gen, z.shape[0], k).to(z.device)]
    for _ in range(iters):
        d = ((z[:, None, :] - mu[None]) ** 2).sum(-1)       # (n, k)
        onehot = F.one_hot(torch.argmin(d, -1), k).to(z.dtype)  # (n, k)
        cnt = onehot.sum(0)
        mu = torch.where(cnt[:, None] > 0,
                         (onehot.T @ z) / torch.clamp(cnt, min=1.0)[:, None],
                         mu)
    return torch.argmin(((z[:, None, :] - mu[None]) ** 2).sum(-1), -1).to(
        torch.int32)


def train_library(app: "App", gen: torch.Generator, x, y, *,
                  library_size: int = 8, scheme: str = "competitive",
                  iters: int = 3, epochs: int = 1500, lr: float = 1e-2,
                  cluster_iters: int = 10) -> MCMA:
    """Co-train a LIBRARY of approximators — MCMA at library scale.

    ``train_mcma`` trains the handful of approximators a deployment keeps
    permanently resident; this trains ``library_size`` of them for the
    residency runtime (``runtime/options.LibrarySpec``).  Initialization
    is ERROR-CLUSTERED: a probe approximator is fit on all data, each
    sample gets a (whitened input, probe residual error) feature vector,
    and k-means over those partitions the input space into
    ``library_size`` territories; each member initializes on its own
    territory.  The usual co-training loop then runs with a
    ``(library_size + 1)``-way classifier.  ``gen`` draws the probe's
    init, the centroids, the members' inits, then the classifier's.
    """
    assert scheme in ("competitive", "complementary")
    assert library_size >= 1
    aspec = app.approx_spec

    # ----- error-clustered initialization ----------------------------------
    probe = train_mlp(init_mlp(gen, aspec), x, y, aspec, epochs=epochs,
                      lr=lr)
    probe_err = quality.approx_errors(app, probe, aspec, x, y)
    assign = _error_clusters(gen, x, probe_err, library_size,
                             iters=cluster_iters)
    a_params = []
    for i in range(library_size):
        w = (assign == i).to(torch.float32)
        # a starved cluster falls back to a faint global fit (same guard
        # as train_mcma territories) rather than training on nothing
        w = torch.where(w.sum() < 8, 0.05 * torch.ones_like(w), w)
        a = init_mlp(gen, aspec, scale=0.3 * (1 + i % 3))
        a_params.append(train_mlp(a, x, y, aspec, weights=w, epochs=epochs,
                                  lr=lr))

    # ----- iterative co-training (the loop of train_mcma) -------------------
    return _co_train(app, gen, x, y, a_params, library_size, scheme, iters,
                     epochs, lr)
