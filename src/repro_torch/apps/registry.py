"""Registry binding each benchmark app to its topologies, data generator,
error semantics and NPU cost constants, Fig. 6 of the paper (counterpart
of ``repro/apps/registry.py``).

The generators draw from an explicit ``torch.Generator`` where the
reference takes a ``jax.random`` key, so the two packages' streams
differ; every constant and field is the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.apps import functions as F
from repro_torch.core.mlp import MLPSpec
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class App:
    name: str
    domain: str
    fn: Callable[[torch.Tensor], torch.Tensor]     # exact target function
    gen: Callable[[torch.Generator, int], torch.Tensor]  # (gen, n) -> inputs
    approx_topo: str                               # Fig. 6 approximator
    cls_topo: str                                  # Fig. 6 classifier
    n_in: int
    n_out: int
    error_bound: float                             # default quality bound
    err_kind: str                                  # "rmse_rel" | "class"
    cpu_cycles: float                              # exact-path cost per call
    n_train: int                                   # paper-scale sizes
    n_test: int
    in_lo: tuple = ()                              # input-normalization
    in_hi: tuple = ()                              # bounds

    def normalize(self, x_raw: torch.Tensor) -> torch.Tensor:
        """Map raw inputs into [-1, 1] for the neural networks."""
        lo = torch.tensor(self.in_lo, dtype=torch.float32,
                          device=x_raw.device)
        hi = torch.tensor(self.in_hi, dtype=torch.float32,
                          device=x_raw.device)
        return (x_raw - lo) / (hi - lo) * 2.0 - 1.0

    @property
    def approx_spec(self) -> MLPSpec:
        return MLPSpec.parse(self.approx_topo)

    def cls_spec(self, n_classes: int = 2) -> MLPSpec:
        """Classifier spec; the last layer widens for MCMA multiclass heads."""
        sizes = MLPSpec.parse(self.cls_topo).sizes[:-1] + (n_classes,)
        return MLPSpec(sizes=sizes, out_act="linear")


def _rand(g: torch.Generator, *shape, lo=0.0, hi=1.0):
    u = torch.rand(*shape, generator=g, device=g.device)
    return u * (hi - lo) + lo


def _uniform(lo, hi):
    def gen(g, n):
        lo_a = torch.tensor(lo, dtype=torch.float32, device=g.device)
        hi_a = torch.tensor(hi, dtype=torch.float32, device=g.device)
        return torch.rand(n, lo_a.shape[0], generator=g, device=g.device) \
            * (hi_a - lo_a) + lo_a
    return gen


def _gen_patches(g, n):
    """Natural-image-like 3x3 patches: luminance ramp + small noise (sobel)."""
    base = _rand(g, n, 1)
    theta = _rand(g, n, 1) * 2 * math.pi
    slope = _rand(g, n, 1, lo=-0.4, hi=0.4)
    ii = torch.arange(3.0, device=g.device) - 1
    ramp = slope[:, 0, None, None] * (
        ii[None, :, None] * torch.cos(theta)[:, :, None]
        + ii[None, None, :] * torch.sin(theta)[:, :, None])
    eps = _rand(g, n, 3, 3, lo=-0.05, hi=0.05)
    return (base[:, :, None] + ramp + eps).clamp(0.0, 1.0).reshape(n, 9)


def _gen_blocks(g, n):
    """8x8 blocks: DC level + 2 random low-frequency cosines + noise (jpeg)."""
    dc = _rand(g, n, 1, 1)
    fx = torch.randint(0, 4, (n, 2), generator=g, device=g.device) \
        .to(torch.float32)
    amp = _rand(g, n, 2, lo=-0.3, hi=0.3)
    ii = torch.arange(8.0, device=g.device)
    wave = (amp[:, 0, None, None] * torch.cos(
                math.pi * fx[:, 0, None, None] * ii[None, :, None] / 8.0)
            + amp[:, 1, None, None] * torch.cos(
                math.pi * fx[:, 1, None, None] * ii[None, None, :] / 8.0))
    return (dc + wave).clamp(0.0, 1.0).reshape(n, 64)


def _gen_triangles(g, n):
    """Triangle pairs with centers drawn close enough that ~half intersect."""
    t1 = _rand(g, n, 9, lo=-1.0, hi=1.0)
    offset = _rand(g, n, 1, 3, lo=-0.8, hi=0.8)
    t2 = _rand(g, n, 3, 3, lo=-1.0, hi=1.0) * 0.9 + offset
    return torch.cat([t1, t2.reshape(n, 9)], dim=-1)


APPS: dict[str, App] = {}


def _register(app: App):
    APPS[app.name] = app
    return app


_register(App("blackscholes", "Financial Analysis", F.blackscholes,
              _uniform([0.5, 0.5, 0.0, 0.0, 0.05, 0.1],
                       [1.5, 1.5, 0.1, 0.05, 0.5, 2.0]),
              "6->8->1", "6->8->2", 6, 1, 0.05, "rmse_rel", 1000.0, 70_000,
              30_000, (0.5, 0.5, 0.0, 0.0, 0.05, 0.1),
              (1.5, 1.5, 0.1, 0.05, 0.5, 2.0)))
_register(App("fft", "Signal Processing", F.fft_twiddle,
              _uniform([0.0], [1.0]),
              "1->2->2->2", "1->2->2", 1, 2, 0.10, "rmse_rel", 70.0, 8_000,
              3_000, (0.0,), (1.0,)))
_register(App("inversek2j", "Robotics", F.inversek2j,
              # reachable annulus-ish box for a (0.5, 0.5) arm
              _uniform([0.05, 0.05], [0.9, 0.9]),
              "2->8->2", "2->8->2", 2, 2, 0.05, "rmse_rel", 600.0, 70_000,
              30_000, (0.05, 0.05), (0.9, 0.9)))
_register(App("jmeint", "3D gaming", F.jmeint,
              _gen_triangles,
              "18->32->16->2", "18->16->2", 18, 2, 0.05, "class", 1100.0,
              70_000, 30_000, (-1.8,) * 18, (1.8,) * 18))
_register(App("jpeg", "Compression", F.jpeg_block,
              _gen_blocks,
              "64->16->64", "64->16->2", 64, 64, 0.05, "rmse_rel", 1300.0,
              4_096, 4_096, (0.0,) * 64, (1.0,) * 64))
_register(App("kmeans", "Machine Learning", F.kmeans_dist,
              _uniform([0.0] * 6, [1.0] * 6),
              "6->8->4->1", "6->8->4->2", 6, 1, 0.05, "rmse_rel", 30.0,
              100_000, 50_000, (0.0,) * 6, (1.0,) * 6))
_register(App("sobel", "Image Processing", F.sobel,
              _gen_patches,
              "9->8->1", "9->8->2", 9, 1, 0.05, "rmse_rel", 90.0, 4_096,
              4_096, (0.0,) * 9, (1.0,) * 9))
_register(App("bessel", "Scientific Computing", F.bessel,
              _uniform([0.0, 0.0], [5.0, 5.0]),
              "2->4->4->1", "2->4->2", 2, 1, 0.05, "rmse_rel", 900.0,
              70_000, 30_000, (0.0, 0.0), (5.0, 5.0)))


def get_app(name: str) -> App:
    return APPS[name]


def function_zoo(domain: str | None = None,
                 names: tuple | None = None) -> tuple[App, ...]:
    """The registry as the approximator-library function zoo: the apps in
    a stable (sorted-by-name) order, so zoo index == library class id, or
    filtered by ``domain`` or an explicit ``names`` tuple."""
    if names is not None:
        return tuple(APPS[n] for n in names)
    apps = sorted(APPS.values(), key=lambda a: a.name)
    if domain is not None:
        apps = [a for a in apps if a.domain == domain]
    return tuple(apps)


def make_dataset(app: App, key, n_train: int | None = None,
                 n_test: int | None = None, *, device=None):
    """Generate (x_train, y_train, x_test, y_test) for an app.

    ``key`` is a ``torch.Generator`` (its device is where the data is
    made) or an int seed for a generator on ``device`` (default: the
    GPU, which must exist).  The training inputs are
    drawn first, then the test inputs, from the one stream.  Sizes default
    to the paper's (Fig. 6).  Inputs come back NORMALIZED to [-1, 1]
    (what the networks consume); targets are the exact function of the
    raw inputs."""
    g = key if isinstance(key, torch.Generator) \
        else torch.Generator(device=resolve_device(device)).manual_seed(
            int(key))
    n_train = n_train or app.n_train
    n_test = n_test or app.n_test
    x_tr = app.gen(g, n_train)
    x_te = app.gen(g, n_test)
    return (app.normalize(x_tr), app.fn(x_tr),
            app.normalize(x_te), app.fn(x_te))
