"""Small MLP substrate used by approximators and classifiers (counterpart
of ``repro/core/mlp.py``).

The paper trains multilayer perceptrons with backpropagation + RMSprop for
1500 epochs.  Topologies come from Fig. 6 (e.g. ``6->8->1`` for the
Black-Scholes approximator).  Parameters keep the reference's layout, a
list of ``{"w": (in, out), "b": (out,)}`` tensors, so they convert leaf by
leaf (``convert.mlp_params_from_jax``).  ``init_mlp`` draws from an
explicit ``torch.Generator`` where the reference takes a ``jax.random``
key.  The reference's one ``lax.scan`` over epochs is an eager loop here:
one autograd step and one RMSprop update an epoch.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

Params = list  # list of {"w": (in, out), "b": (out,)}


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Topology spec: ``sizes=(6, 8, 1)`` means 6->8->1."""

    sizes: tuple
    hidden_act: str = "tanh"
    out_act: str = "linear"      # regression output by default

    @staticmethod
    def parse(topo: str, **kw) -> "MLPSpec":
        """Parse a paper-style topology string like ``"6->8->1"``."""
        sizes = tuple(int(t) for t in topo.replace(" ", "").split("->"))
        return MLPSpec(sizes=sizes, **kw)

    @property
    def n_layers(self) -> int:
        return len(self.sizes) - 1

    @property
    def n_macs(self) -> int:
        """Multiply-accumulates per forward pass (the NPU cost model's)."""
        return int(sum(a * b for a, b in zip(self.sizes[:-1], self.sizes[1:])))

    @property
    def n_params(self) -> int:
        return int(sum(a * b + b
                       for a, b in zip(self.sizes[:-1], self.sizes[1:])))


_ACTS: dict = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "linear": lambda x: x,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def init_mlp(gen: torch.Generator, spec: MLPSpec, dtype=torch.float32,
             scale: float | None = None) -> Params:
    """Glorot-uniform init drawn from ``gen`` in layer order, on the
    generator's device, zero biases; ``scale`` overrides the per-layer
    fan-based scale (used by competitive co-training to diversify local
    minima)."""
    params = []
    for fan_in, fan_out in zip(spec.sizes[:-1], spec.sizes[1:]):
        s = scale if scale is not None else (6.0 / (fan_in + fan_out)) ** 0.5
        u = torch.rand(fan_in, fan_out, generator=gen, device=gen.device,
                       dtype=dtype)
        params.append({"w": u * (2 * s) - s,
                       "b": torch.zeros(fan_out, dtype=dtype,
                                        device=gen.device)})
    return params


def mlp_logits(params: Params, x: torch.Tensor,
               spec: MLPSpec) -> torch.Tensor:
    """Forward pass returning pre-output-activation logits (classifiers)."""
    h = x
    hidden = _ACTS[spec.hidden_act]
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = hidden(h)
    return h


def apply_mlp(params: Params, x: torch.Tensor, spec: MLPSpec) -> torch.Tensor:
    """Forward pass. ``x``: (..., in_features) -> (..., out_features)."""
    return _ACTS[spec.out_act](mlp_logits(params, x, spec))


# ---------------------------------------------------------------------------
# RMSprop training (paper setup), full batch.
# ---------------------------------------------------------------------------

@torch.no_grad()
def _rmsprop_update(params, grads, ms, lr, decay=0.9, eps=1e-8):
    """The reference's update on flat lists of tensors, IN PLACE, in its
    order of operations: ``m = decay m + (1 - decay) g g``, then ``p = p -
    lr g / (sqrt(m) + eps)``.  Returns ``(params, ms)``."""
    torch._foreach_mul_(ms, decay)
    gg = torch._foreach_mul(grads, 1 - decay)
    torch._foreach_mul_(gg, grads)
    torch._foreach_add_(ms, gg)
    den = torch._foreach_sqrt(ms)
    torch._foreach_add_(den, eps)
    step = torch._foreach_mul(grads, lr)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(params, step)
    return params, ms


def _weighted_mean(err, weights):
    if weights is None:
        return err.mean()
    # Weighted mean: lets callers mask out samples outside a territory
    # while keeping shapes static.
    return (err * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def mse_loss(params, x, y, spec, weights=None):
    pred = apply_mlp(params, x, spec)
    return _weighted_mean(((pred - y) ** 2).sum(-1), weights)


def xent_loss(params, x, labels, spec, weights=None):
    logp = torch.log_softmax(mlp_logits(params, x, spec), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return _weighted_mean(nll, weights)


def balanced_weights(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Inverse-frequency sample weights (mean 1) so minority classes train.
    The counts are a float32 scatter-add into ``n_classes`` bins (JAX's
    ``bincount(length=n)``; ``torch.bincount`` is int64 and sizes its
    output from the data, which waits for the device)."""
    counts = torch.zeros(n_classes, dtype=torch.float32,
                         device=labels.device)
    counts.index_add_(0, labels.long(),
                      torch.ones(labels.shape, dtype=torch.float32,
                                 device=labels.device))
    w = 1.0 / torch.clamp(counts, min=1.0)
    w = w / (w * counts).sum() * labels.shape[0]
    return w[labels.long()]


def train_mlp(params: Params, x: torch.Tensor, y: torch.Tensor,
              spec: MLPSpec, *, weights: torch.Tensor | None = None,
              loss: str = "mse", epochs: int = 1500,
              lr: float = 1e-2) -> Params:
    """Full-batch RMSprop for ``epochs`` steps (paper: RMSprop, epoch=1500).

    ``weights`` is an optional per-sample mask/weight vector; masked-out
    samples contribute zero gradient, which is how territories are selected
    without dynamic shapes.  ``params`` is not modified: training runs on
    copies on ``x``'s device, which the result lives on.
    """
    loss_fn = mse_loss if loss == "mse" else xent_loss
    p = [{k: v.detach().to(x.device, copy=True).requires_grad_(True)
          for k, v in layer.items()} for layer in params]
    leaves = [layer[k] for layer in p for k in ("w", "b")]
    ms = [torch.zeros_like(v) for v in leaves]
    with torch.enable_grad():
        for _ in range(epochs):
            grads = torch.autograd.grad(loss_fn(p, x, y, spec, weights),
                                        leaves)
            _rmsprop_update(leaves, list(grads), ms, lr)
    train_mlp.calls += 1
    return [{k: v.detach() for k, v in layer.items()} for layer in p]


train_mlp.calls = 0   # calls made; chip_smoke.py reads it for epochs/s
