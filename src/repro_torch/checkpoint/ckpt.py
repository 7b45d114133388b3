"""Atomic checkpointing (counterpart of ``repro/checkpoint/ckpt.py``), in
the reference's on-disk layout.

* A checkpoint is ``<dir>/step_%09d/`` holding ``arrays.npz`` (one array
  per leaf, under sanitized names) and ``manifest.json`` (each leaf's
  path, name, dtype and shape, and the step).  Paths join nested dict
  keys and list indices with "/"; an empty subtree is stored as the
  ``_EMPTY`` sentinel.  Nothing of a device or a mesh is stored.
* bfloat16 leaves are stored as their 16-bit patterns (a ``uint16`` view)
  with ``"bfloat16"`` as the manifest's dtype, which is also how a
  reference checkpoint's bfloat16 leaves read back.
* Writes are atomic: everything goes to ``<dir>/tmp.<step>``, the manifest
  is fsynced, and the directory is renamed to ``step_<k>``; a step
  directory without a manifest does not count.
* ``keep_k`` garbage collection keeps the newest k checkpoints.

``save`` takes a pytree of tensors (nested dicts, lists and tuples; numpy
arrays, scalars and strings too) and ``restore`` gives back the pytree of
CPU tensors.  The trainer saves its state as the reference's pytree
(``save_train_state``: ``convert.train_state_to_tree``), so the port and
the reference read each other's checkpoints.  Checkpoints are
mesh-agnostic: a mesh saves every leaf whole and ``restore_train_state``
shards it onto whatever mesh (or one device) restores it.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch import convert
from repro_torch.sharding import collectives as C

_EMPTY = "__empty_dict__"  # sentinel: empty subtree (e.g. non-param LN {})


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix[:-1]] = _EMPTY
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[prefix[:-1]] = _EMPTY
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = {} if isinstance(v, str) and v == _EMPTY else v

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def _to_host(v):
    """A leaf as (numpy array, manifest dtype)."""
    if isinstance(v, str):
        return np.asarray(v), str(np.asarray(v).dtype)
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    if a.dtype.kind == "U":
        return str(a)
    return torch.from_numpy(np.array(a))


def save(ckpt_dir: str, step: int, state, *, keep_k: int = 3) -> str:
    host = {k: _to_host(v) for k, v in _flatten(state).items()}
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # npz with sanitized names + manifest mapping
    names = {k: f"a{i}" for i, k in enumerate(host)}
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{names[k]: a for k, (a, _) in host.items()})
    manifest = {"step": step,
                "paths": {k: {"name": names[k], "dtype": dt,
                              "shape": list(a.shape)}
                          for k, (a, dt) in host.items()}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_k)
    return final


def _gc(ckpt_dir: str, keep_k: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_k] if keep_k else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int | None = None):
    """Returns (state, step): the pytree of CPU tensors saved at ``step``
    (default: the newest), or (None, None) when there is none."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        flat = {k: _from_host(arrays[meta["name"]], meta["dtype"])
                for k, meta in manifest["paths"].items()}
    return _unflatten(flat), step


def save_train_state(ckpt_dir: str, step: int, cfg, state, *, mesh=None,
                     keep_k: int = 3):
    """Save a port train state in the reference's layout.  On ``mesh``
    every rank passes its shards: each leaf is gathered whole, rank 0
    writes, and the ranks meet at a barrier, so the checkpoint is the one
    device's whatever mesh wrote it.  Returns the checkpoint's path (None
    on the other ranks)."""
    tree = convert.train_state_to_tree(cfg, state, mesh=mesh)
    path = save(ckpt_dir, step, tree, keep_k=keep_k) \
        if mesh is None or mesh.rank == 0 else None
    if mesh is not None:
        C.barrier()
    return path


def restore_train_state(ckpt_dir: str, cfg, *, mesh=None, device=None,
                        step: int | None = None):
    """(port train state, step) from the newest checkpoint (or ``step``),
    or (None, None) when there is none: the leaves read whole, and on
    ``mesh`` sharded by ``sharding/rules.state_pspecs`` onto ``device``
    (``convert.train_state_from_jax``)."""
    tree, at = restore(ckpt_dir, step)
    if tree is None:
        return None, None
    return convert.train_state_from_jax(cfg, tree, device=device,
                                        mesh=mesh), at
