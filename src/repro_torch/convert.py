"""Convert between the reference package's pytrees and the port's model,
train state and paper-MLP parameters.

The reference keeps matrices as ``(in, out)`` and the approximator stacks
in serving form, and so does the port, so conversion is leaf by leaf with
no transposes: the stacked ``blocks`` leaves (leading dim L) split into
``blocks.<i>.*`` (the MoE's too: ``blocks.<i>.moe.router``, ``.w_in``,
``.w_gate``, ``.w_out``; ``mlstm`` and ``mamba`` into
``<head>.<g>.<p>.*``, ``slstm`` into ``slstm.<g>.*``), every other key
(the hybrid's unstacked ``shared`` block too) maps to the same dotted
name.  A parameterless
norm (olmo's ``nonparam_ln``) is an empty dict in the reference and
nothing here.  bfloat16 leaves cross as their 16-bit patterns
(``torch.from_numpy`` has no bfloat16).  ``train_state_to_tree`` goes the
other way, to the reference's stacked layout with its empty dicts, which
is the checkpoints' on-disk layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import Norm
from repro_torch.models.model import Model, topology
from repro_torch.sharding import collectives as C


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def to_torch(a) -> torch.Tensor:
    """A numpy array (bfloat16 included) or a tensor as a CPU tensor of
    the same dtype, which owns its storage."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    a = np.array(a, order="C")          # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _stacked(cfg: ModelConfig) -> dict:
    """Top-level key of each stacked reference leaf -> the leading dims
    the port splits off."""
    topo = topology(cfg)
    return {"blocks": (cfg.n_layers,),
            "mlstm": (topo.n_groups, topo.per_group),
            "mamba": (topo.n_groups, topo.per_group),
            "slstm": (topo.n_groups,)}


def _split(cfg: ModelConfig, tree) -> dict:
    """A reference pytree of the model's shape as {port name: CPU tensor}."""
    stacked, out = _stacked(cfg), {}
    for name, leaf in _flatten(tree):
        t = to_torch(leaf)
        head, _, rest = name.partition(".")
        lead = stacked.get(head)
        if lead is None:
            out[name] = t
            continue
        assert t.shape[:len(lead)] == lead, (name, t.shape, lead)
        for idx in np.ndindex(*lead):
            out[".".join(map(str, (head, *idx, rest)))] = t[idx]
    return out


def _empty_paths(cfg: ModelConfig, params: Model) -> set:
    """Key paths, stacked indices dropped, of the parameterless norms:
    the reference's empty dicts."""
    stacked, out = _stacked(cfg), set()
    for name, mod in params.named_modules():
        if isinstance(mod, Norm) and not list(mod.parameters()):
            head, *parts = name.split(".")
            out.add((head, *parts[len(stacked.get(head, ())):]))
    return out


def _stack(cfg: ModelConfig, flat: dict, empty: set) -> dict:
    """{port name: tensor} back to the reference's nested, stacked pytree
    of CPU tensors, with an empty dict at each path of ``empty``."""
    stacked, groups, tree = _stacked(cfg), {}, {}
    for name, t in flat.items():
        head, *parts = name.split(".")
        lead = stacked.get(head, ())
        idx = tuple(int(i) for i in parts[:len(lead)])
        key = (head, *parts[len(lead):])
        groups.setdefault(key, {})[idx] = t.detach().cpu()
    for key, by_idx in groups.items():
        lead = stacked.get(key[0], ())
        if lead:
            leaf = torch.stack([by_idx[i] for i in np.ndindex(*lead)])
            leaf = leaf.reshape(*lead, *leaf.shape[1:])
        else:
            leaf = by_idx[()]
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = leaf
    for key in empty:
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = {}
    return tree


def params_from_jax(cfg: ModelConfig, tree, *, device=None) -> Model:
    """The port's ``Model`` holding the JAX parameter pytree ``tree``
    (nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, p)``).
    Every leaf must land on a parameter of the same shape and dtype, and
    every parameter must be covered."""
    model = Model(cfg, resolve_device(device))
    state = _split(cfg, tree)
    own = dict(model.named_parameters())
    for name, t in state.items():
        if name in own and own[name].dtype != t.dtype:
            raise TypeError(f"{name}: checkpoint {t.dtype} != model "
                            f"{own[name].dtype}")
    model.load_state_dict(state, strict=True)
    return model


def decay_mask(cfg: ModelConfig, params: Model) -> dict[str, bool]:
    """{name: whether AdamW decays it}: the reference decays a leaf of rank
    >= 2, and its leaves are stacked over layers, so every per-layer
    tensor (norm scales and biases included, every MoE leaf) is decayed
    and only the unstacked 1-D leaves (``ln_f``, the hybrid's ``shared``
    norms and biases) are exempt."""
    stacked = _stacked(cfg)
    return {name: p.ndim + len(stacked.get(name.partition(".")[0], ())) >= 2
            for name, p in params.named_parameters()}


def train_state_from_jax(cfg: ModelConfig, state, *, device=None,
                         mesh=None) -> dict:
    """The port's train state ``{"params": Model, "opt": {"m", "v"},
    "step"}`` from a reference train state (``runtime/steps.
    init_train_state``'s pytree, numpy or tensor leaves): the parameters
    as ``params_from_jax`` loads them, trainable; the AdamW moments split
    per layer like the parameters, float32 under the parameters' names;
    ``step`` an int32 scalar tensor.  On ``mesh`` every parameter and
    moment is this rank's shard under ``sharding/rules.state_pspecs``
    (loaded whole on the CPU, then sharded and moved)."""
    dev = resolve_device(device)
    params = params_from_jax(cfg, state["params"],
                             device="cpu" if mesh is not None else dev)
    own = dict(params.named_parameters())
    opt = {}
    for k in ("m", "v"):
        flat = _split(cfg, state["opt"][k])
        if flat.keys() != own.keys():
            raise KeyError(f"opt[{k!r}] does not cover the parameters: "
                           f"{sorted(flat.keys() ^ own.keys())[:4]}")
        for name, t in flat.items():
            if t.shape != own[name].shape or t.dtype != torch.float32:
                raise TypeError(f"opt[{k!r}][{name!r}]: {t.dtype} "
                                f"{tuple(t.shape)}")
        opt[k] = {name: flat[name] for name in own}
    if mesh is not None:
        specs = C.shard_params(mesh, params, dev)
        opt = {k: {n: C.shard_tensor(mesh, t, specs[n]) for n, t in m.items()}
               for k, m in opt.items()}
    params.requires_grad_(True)
    opt = {k: {n: t.to(dev) for n, t in m.items()} for k, m in opt.items()}
    step = to_torch(state["step"]).to(device=dev, dtype=torch.int32)
    return {"params": params, "opt": opt, "step": step.reshape(())}


def train_state_to_tree(cfg: ModelConfig, state, *, mesh=None) -> dict:
    """A port train state as the reference's pytree of CPU tensors
    (stacked leaves, nested dicts): what ``train_state_from_jax`` reads
    back, and the layout checkpoints are written in.  An unstacked leaf
    of a state on the CPU shares its storage with the state.  On
    ``mesh`` the state is this rank's shards: each leaf is gathered whole
    (a collective: every rank calls it) by its parameter's spec."""
    empty = _empty_paths(cfg, state["params"])
    named = dict(state["params"].named_parameters())
    whole = (lambda k, t: t) if mesh is None else \
        (lambda k, t: C.gather_whole(t.detach(), named[k]._pspec,
                                     mesh).cpu())
    return {"params": _stack(cfg, {k: whole(k, p) for k, p in named.items()},
                             empty),
            "opt": {m: _stack(cfg, {k: whole(k, t)
                                    for k, t in state["opt"][m].items()},
                              empty)
                    for m in ("m", "v")},
            "step": state["step"].detach().cpu()}


def mlp_params_from_jax(params, *, device=None) -> list:
    """A paper MLP's parameters (``core/mlp.py``'s list of ``{"w": (in,
    out), "b": (out,)}``, numpy or tensor leaves, e.g. ``[{k:
    np.asarray(v) ...} ...]`` of a JAX pytree) as the port's, on
    ``device``: the same layout, leaf by leaf."""
    dev = resolve_device(device)
    return [{k: to_torch(layer[k]).to(dev) for k in ("w", "b")}
            for layer in params]


def mlp_params_to_numpy(params) -> list:
    """The port's paper-MLP parameters as the reference's list of ``{"w",
    "b"}`` numpy arrays (what ``jnp.asarray`` takes back)."""
    return [{k: layer[k].detach().cpu().numpy() for k in ("w", "b")}
            for layer in params]
