"""Dry run of the production meshes (counterpart of
``repro/launch/dryrun.py``): rank 0's step of every (arch x shape) cell,
recorded on an H100 roofline without a card.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k \\
        --mesh single --approx
    python -m repro_torch.launch.dryrun --all --mesh-all --device cpu
    python -m repro_torch.launch.roofline

The reference lowers and compiles each cell with XLA and reads the
compiled artifact.  Here the artifact is the op stream of rank 0's step,
recorded by ``launch/hlo_cost.analyze`` under ``FakeTensorMode`` on a
fake process group the size of ``launch/mesh.make_production_mesh``'s
mesh (256 ranks as (16, 16), or 512 as (2, 16, 16) with ``--mesh
multi``): nothing is allocated and nothing runs on a card, and every
collective goes through the port's own ``sharding/collectives.py``.  A
process group is global to its process, so each cell is one process
(``--all`` runs one subprocess per cell).  ``--device`` (default
``cuda``) places the fake tensors; a CPU-only torch traces on ``cpu``,
and the record is the same (kernels and attention are opaque ops,
``hlo_cost``).

A cell the port refuses on its mesh (``models/model.check_mesh_servable``
/ ``check_mesh_trainable``, the train microbatch being global_batch /
``cfg.grad_accum``) is written with ``"ok": false`` and the refusal as
its ``error``, as the reference writes a failed compile.  ``--approx``
serves the ApproxFFN through the MCMA dispatch engine on its default
backend (the switch kernel, ``runtime/steps.mcma_serve_config``);
``--act-shard`` is recorded only: each rank holds its own rows, and there
is no partitioner to steer (``sharding/activations.py``).

Per cell this writes runs/dryrun/<arch>__<shape>__<mesh>[__tag].json:
  memory       (bytes a rank: the arguments exactly from its shard shapes,
                i.e. parameters, in training the AdamW moments, in decode
                the cache, and the inputs; the live-bytes high-water of
                the step above them; their sum as ``peak_bytes``)
  cost         (FLOPs and device bytes a rank, ``hlo_cost``)
  collectives  (wire bytes a rank by kind, as the port sends them and by
                the ring model; bytes of groups spanning nodes)
  kernels      (each kernel wrapper's ops and their work)
  model_flops  (6*N*D train / 2*N*D forward, N = active params)
  t_trace_s    (the recording's wall seconds)

``roofline_terms`` puts a cell on the H100 (SXM, 80 GB): compute at the
bf16 dense tensor-core rate, memory at the HBM rate, collectives at the
link rates.  The layout of ranks on nodes is this port's assumption, not
the reference's: rank r lies on node r // 8 (eight cards a node, as in a
DGX H100), so a group of consecutive ranks within eight shares NVLink,
and a collective whose group spans nodes moves its bytes over
InfiniBand (``hlo_cost``'s ``internode_bytes``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "runs",
                       "dryrun")

# ---------------------------------------------------------------------------
# H100 SXM rates a card (none of the reference's TPU v5e figures)
# ---------------------------------------------------------------------------

PEAK_FLOPS = 989e12      # bf16 dense tensor core: NVIDIA H100 SXM data sheet
HBM_BW = 3.35e12         # HBM3: NVIDIA H100 SXM data sheet
NVLINK_BW = 450e9        # NVLink 4, 900 GB/s a card both ways: 450e9 each
IB_BW = 50e9             # one 400 Gb/s NDR InfiniBand port a card, each way
                         # (NVIDIA DGX H100 data sheet)
NODE_SIZE = 8            # cards a node (DGX H100); rank r on node r // 8
HBM_BYTES = 80 * 2**30   # the card's 80 GB, taken as 80 GiB


def _count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _nbytes(tree) -> int:
    from repro_torch.launch.hlo_cost import _tensors
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _mesh_layout(mesh_kind: str, mesh_shape=None):
    """(shape, axis names) of the cell's mesh."""
    if mesh_shape is not None:
        shape = tuple(mesh_shape)
    else:
        shape = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    axes = ("pod", "data", "model")[-len(shape):]
    return shape, axes


def _shard_shape(shape, spec, mesh) -> tuple:
    return tuple(d // mesh.size(s) if s is not None else d
                 for d, s in zip(shape, tuple(spec) + (None,) * len(shape)))


def rank_cache(glob: dict, mesh, device):
    """This rank's shard of the decode cache ``glob`` (the global cache on
    the meta device): zeros of the shard shapes that
    ``sharding/rules.cache_pspecs`` gives it, so the whole cache never
    exists."""
    import torch

    from repro_torch.sharding.rules import cache_pspecs

    def build(tree, specs):
        return {k: build(v, specs[k]) if isinstance(v, dict) else
                torch.zeros(_shard_shape(v.shape, specs[k], mesh),
                            dtype=v.dtype, device=device)
                for k, v in tree.items()}
    return build(glob, cache_pspecs(mesh, glob))


def cell_config(arch: str, *, approx: bool = False, cfg=None):
    """The cell's config: ``arch``'s (or ``cfg``), the ApproxFFN on with
    ``approx``."""
    from repro_torch.configs.registry import get_config
    cfg = cfg or get_config(arch)
    if approx:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    return cfg


def cell_step(cfg, shape, mesh, device, *, fake: bool = True):
    """(step, args, argument bytes) of rank 0's part of the cell on
    ``mesh``: the user entry points of ``runtime/steps.py`` on this
    rank's state.  ``fake``: uninitialized parameter shards (no draw);
    else parameters drawn from seed 0.  Inputs are zeros."""
    import torch

    from repro_torch.configs.registry import input_specs
    from repro_torch.data.pipeline import local_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import steps as S
    params = M.init_model(None if fake else 0, cfg, device=device, mesh=mesh)
    specs = input_specs(cfg, shape, device="meta")
    zeros = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in specs.items() if k != "cache"}
    if shape.kind == "train":
        params.requires_grad_(True)
        state = {"params": params,
                 "opt": adamw_init(dict(params.named_parameters())),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        batch = local_batch(zeros, mesh, cfg.grad_accum)
        args = (state, batch)
        step = S.make_train_step(cfg, grad_accum=cfg.grad_accum)
    elif shape.kind == "prefill":
        batch = local_batch(zeros, mesh)
        args = (params, batch)
        step = S.make_prefill_step(
            S.mcma_serve_config(cfg) if cfg.approx.enable else cfg)
    else:
        cache = rank_cache(specs["cache"], mesh, device)
        args = (params, cache, zeros["inputs"])
        step = S.make_decode_step(cfg, use_mcma_dispatch=cfg.approx.enable)

    micro = shape.global_batch // cfg.grad_accum \
        if shape.kind == "train" else 0

    def run(*a):
        with S.train_mesh_context(mesh, micro):
            return step(*a)
    return run, args, _nbytes(args)


def model_numbers(cfg, shape, meta=None) -> dict:
    """{"n_params", "n_active", "model_flops"} of a cell: 6·N·D in
    training, 2·N·D in a forward (D the tokens of the step), N the
    active parameters (an MoE's routed experts only)."""
    import torch

    from repro_torch.models import model as M
    meta = meta if meta is not None else M.Model(cfg, torch.device("meta"))
    n_params = _count_params(meta)
    flops_mult = {"train": 6 * shape.global_batch * shape.seq_len,
                  "prefill": 2 * shape.global_batch * shape.seq_len,
                  "decode": 2 * shape.global_batch}[shape.kind]
    if cfg.moe.n_experts:
        dense_ffn = cfg.n_layers * (3 if cfg.gated_ffn else 2) \
            * cfg.d_model * cfg.d_ff
        n_active = n_params - (cfg.moe.n_experts - cfg.moe.top_k) * dense_ffn
    else:
        n_active = n_params
    return {"n_params": int(n_params), "n_active": int(n_active),
            "model_flops": float(flops_mult) * n_active}


def fake_world(size: int):
    """Rank 0 of a fake process group of ``size`` ranks in this process
    (``torch.testing``'s ``FakeStore``): its collectives send nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             approx: bool = False, act_shard: str = "", tag: str = "",
             device: str = "cuda", cfg=None, shape=None, mesh_shape=None,
             fake: bool = True) -> dict:
    """Record rank 0's step of one cell.  Without a process group this
    starts a fake one of the mesh's size; inside a real one (a test's
    gloo world, ``fake=False``) the step runs on real tensors.  ``cfg``,
    ``shape`` and ``mesh_shape`` replace the arch's config, the named
    shape and the production mesh (the tests' small cells)."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.mesh import HostMesh, MeshShape
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import param_pspecs

    cfg = cell_config(arch, approx=approx, cfg=cfg)
    act_shard = act_shard or cfg.act_shard
    shape = shape or SHAPES[shape_name]
    layout, axes = _mesh_layout(mesh_kind, mesh_shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "chips": math.prod(layout), "approx": approx,
              "act_shard": act_shard, "ok": False}

    meta, planned = M.Model(cfg, torch.device("meta")), MeshShape(layout,
                                                                    axes)
    result.update(model_numbers(cfg, shape, meta))
    _, report = param_pspecs(planned, meta)
    result["sharding_fallbacks"] = report.fallbacks

    try:
        if shape.kind == "train":
            M.check_mesh_trainable(cfg, planned,
                                   shape.global_batch // cfg.grad_accum,
                                   shape.seq_len)
        else:
            M.check_mesh_servable(
                cfg, planned, shape.global_batch,
                max_len=shape.seq_len if shape.kind == "decode" else 0)
    except NotImplementedError as e:      # the port refuses this layout
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
        return result

    if not dist.is_initialized():
        fake_world(math.prod(layout))
    mesh = HostMesh(layout, axes)
    t0 = time.time()
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else None
    with mode or contextlib.nullcontext():
        step, args, arg_bytes = cell_step(cfg, shape, mesh, device,
                                          fake=fake)
        cost = hlo_cost.analyze(step, args, node_size=NODE_SIZE)
    result["t_trace_s"] = round(time.time() - t0, 1)
    result["memory"] = {
        "argument_bytes": arg_bytes,
        "temp_peak_bytes": cost.temp_peak_bytes,
        "peak_bytes": arg_bytes + cost.temp_peak_bytes,
    }
    result["fits_80g"] = result["memory"]["peak_bytes"] <= HBM_BYTES
    result["cost"] = {"flops_per_chip": cost.flops,
                      "bytes_per_chip": cost.bytes, "n_ops": cost.n_ops}
    result["collectives"] = {
        "wire_bytes_per_chip": cost.wire_bytes,
        "internode_bytes_per_chip": cost.internode_bytes,
        "by_kind": cost.coll_by_kind, "counts": cost.coll_counts,
        "ring_by_kind": cost.ring_by_kind,
        "n_while": cost.n_while, "max_trip": cost.max_trip}
    result["kernels"] = cost.kernels
    result["attention"] = cost.attention
    result["ok"] = True
    return result


def roofline_terms(cell: dict) -> dict:
    """The cell's three terms on the H100, its bottleneck, the useful
    FLOPs ratio (model FLOPs over the port's FLOPs on every rank) and
    the roofline fraction (the compute term over the largest)."""
    c = cell["cost"]
    coll = cell["collectives"]
    t_compute = c["flops_per_chip"] / PEAK_FLOPS
    t_memory = c["bytes_per_chip"] / HBM_BW
    inter = coll["internode_bytes_per_chip"]
    t_coll = (coll["wire_bytes_per_chip"] - inter) / NVLINK_BW \
        + inter / IB_BW
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    total_flops = c["flops_per_chip"] * cell["chips"]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "bottleneck": dom,
            "useful_flops_ratio": cell["model_flops"] / max(total_flops, 1.0),
            "roofline_frac": t_compute / max(t_compute, t_memory, t_coll,
                                             1e-30)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cell_path(out_dir, arch, shape, mesh, tag):
    name = f"{arch}__{shape}__{mesh}" + (f"__{tag}" if tag else "")
    return os.path.join(out_dir, name + ".json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--approx", action="store_true",
                    help="enable the ApproxFFN (MCMA) layer")
    ap.add_argument("--act-shard", choices=["", "dp", "sp", "fp", "none"],
                    default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true",
                    help="sweep every cell in fresh subprocesses")
    ap.add_argument("--mesh-all", action="store_true",
                    help="with --all: both meshes (default: single only)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cpu on a CPU-only "
                         "torch)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        from repro_torch.configs.registry import ARCH_IDS, cells
        meshes = ["single", "multi"] if args.mesh_all else ["single"]
        todo = [(a, sh.name, m) for a in ARCH_IDS for sh in cells(a)
                for m in meshes]
        ok = refused = failed = 0
        t0 = time.time()
        for a, s, m in todo:
            path = _cell_path(args.out, a, s, m, args.tag)
            if os.path.exists(path) and not args.force:
                print(f"skip {a} {s} {m} (exists)")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m, "--out", args.out,
                   "--device", args.device]
            for flag, val in (("--tag", args.tag),
                              ("--act-shard", args.act_shard)):
                if val:
                    cmd += [flag, val]
            if args.approx:
                cmd.append("--approx")
            print(f"[{ok + refused + failed + 1}/{len(todo)}] {a} {s} {m} "
                  "...", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True)
            cell = json.load(open(path)) if os.path.exists(path) else {}
            if cell.get("ok"):
                ok += 1
            elif _refused(cell):
                refused += 1
            else:
                failed += 1
                print(r.stdout[-1500:], r.stderr[-1500:], flush=True)
        print(f"sweep: {ok} ok, {refused} refused, {failed} failed in "
              f"{time.time() - t0:.1f} s")
        return 1 if failed else 0

    cell = run_cell(args.arch, args.shape, args.mesh, approx=args.approx,
                    act_shard=args.act_shard, tag=args.tag,
                    device=args.device)
    if cell["ok"]:
        cell["roofline"] = roofline_terms(cell)
    path = _cell_path(args.out, args.arch, args.shape, args.mesh, args.tag)
    with open(path, "w") as f:
        json.dump(cell, f, indent=1)
    print(json.dumps(cell, indent=1))
    return 0 if cell["ok"] or _refused(cell) else 1


def _refused(cell: dict) -> bool:
    """A cell the port refuses on its mesh (not a failure of the run)."""
    return cell.get("error", "").startswith("NotImplementedError")


if __name__ == "__main__":
    sys.exit(main())
