"""Load a JAX checkpoint of the reference package into the port's model.

The reference keeps matrices as ``(in, out)`` and the approximator stacks
in serving form, and so does the port, so conversion is leaf by leaf with
no transposes: the stacked ``blocks`` leaves (leading dim L) split into
``blocks.<i>.*``, every other key maps to the same dotted name.  bfloat16
leaves cross as their 16-bit patterns (``torch.from_numpy`` has no
bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, topology


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def to_torch(a) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a CPU tensor of the same dtype."""
    a = np.array(a, order="C")          # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(cfg: ModelConfig, tree, *, device=None) -> Model:
    """The port's ``Model`` holding the JAX parameter pytree ``tree``
    (nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, p)``).
    Every leaf must land on a parameter of the same shape and dtype, and
    every parameter must be covered."""
    model = Model(cfg, resolve_device(device))
    topo = topology(cfg)
    # stacked leaves: top-level key -> the leading dims to split off
    stacked = {"blocks": (cfg.n_layers,),
               "mlstm": (topo.n_groups, topo.per_group),
               "slstm": (topo.n_groups,)}
    state = {}
    for name, leaf in _flatten(tree):
        t = to_torch(leaf)
        head, _, rest = name.partition(".")
        lead = stacked.get(head)
        if lead is None:
            state[name] = t
            continue
        assert t.shape[:len(lead)] == lead, (name, t.shape, lead)
        for idx in np.ndindex(*lead):
            key = ".".join(map(str, (head, *idx, rest)))
            state[key] = t[idx]
    own = dict(model.named_parameters())
    for name, t in state.items():
        if name in own and own[name].dtype != t.dtype:
            raise TypeError(f"{name}: checkpoint {t.dtype} != model "
                            f"{own[name].dtype}")
    model.load_state_dict(state, strict=True)
    return model
