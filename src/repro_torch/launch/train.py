"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --approx --smoke --steps 50 --ckpt-dir runs/ck [--device cpu]

Drives the ``Trainer`` on one device: the GPU unless ``--device cpu`` is
given.  ``--smoke`` selects the reduced config; ``--approx`` enables the
MCMA ApproxFFN layer (with its tick-router head; an MoE architecture
trains its MoE instead).  The port trains every architecture that reads
tokens.

``--mesh D,M`` trains on a (D, M) ("data", "model") mesh: D * M ranks,
one process each (``launch/mesh.spawn_world``, gloo), each building the
same Trainer; on the CPU with ``--device cpu``, else every rank on the
GPU (ranks share the card when there is one).  Rank 0 prints.  Every
family trains there when the mesh divides it
(``model.check_mesh_trainable``): the MoE expert-parallel with the model
axis dividing its experts (e.g. ``--arch moonshot-v1-16b-a3b --mesh
2,2``), else with it dividing each expert's d_ff (TP-in-expert); the kv
heads dividing it or below it with head_dim dividing it; the hybrid and
the xLSTM with it dividing their heads (e.g. ``--arch zamba2-2.7b --mesh
2,2``).  A microbatch (``--batch`` / ``--grad-accum``) that does not
divide over D trains with every row on every data rank and its
``--seq-len`` positions split over them (e.g. ``--batch 2 --mesh 4,2``).
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--approx", action="store_true",
                    help="enable the MCMA ApproxFFN layer")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="", help="e.g. '4,2' => (data, model)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.runtime.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.approx:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    if args.mesh:
        return _spawn_mesh(args, cfg)
    out = Trainer(cfg, _trainer_config(args), _dataset(args, cfg),
                  seed=args.seed, device=args.device).run()
    print(f"done: {out}")
    return out


def _dataset(args, cfg):
    from repro_torch.data.pipeline import SyntheticLM
    return SyntheticLM(vocab=cfg.vocab, seq_len=args.seq_len,
                       global_batch=args.batch, seed=args.seed)


def _trainer_config(args):
    from repro_torch.runtime.trainer import TrainerConfig
    return TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, base_lr=args.lr,
                         warmup=max(args.steps // 10, 1),
                         grad_accum=args.grad_accum)


def _spawn_mesh(args, cfg):
    """Train on a ("data", "model") mesh of D * M ranks; returns rank 0's
    result.  The mesh is checked before any process starts, and a rank's
    exception fails the launch."""
    import json
    import math
    import tempfile

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import MeshShape, spawn_world
    from repro_torch.models.model import check_mesh_trainable
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != 2:
        raise ValueError(f"--mesh takes D,M; got {args.mesh!r}")
    resolve_device(args.device)           # no GPU and no --device: raise
    check_mesh_trainable(cfg, MeshShape(shape),
                         args.batch // max(args.grad_accum, 1), args.seq_len)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_world(mesh_rank, math.prod(shape), (args, cfg, shape, tmp))
        with open(f"{tmp}/result.json") as f:
            out = json.load(f)
    print(f"done: {out}")
    return out


def mesh_rank(rank, args, cfg, shape, out_dir):
    """One rank of ``--mesh``: the Trainer on its mesh; rank 0 writes the
    result to ``out_dir``."""
    import json

    import torch

    from repro_torch.launch.mesh import HostMesh
    from repro_torch.runtime.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    device = args.device
    if device is None:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = "cuda"
    else:
        torch.set_num_threads(1)
    mesh = HostMesh(shape, ("data", "model"))
    out = Trainer(cfg, _trainer_config(args), _dataset(args, cfg),
                  mesh=mesh, seed=args.seed, device=device).run()
    if rank == 0:
        with open(f"{out_dir}/result.json", "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
