"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --approx --smoke --steps 50 --ckpt-dir runs/ck [--device cpu]

Drives the ``Trainer`` on one device: the GPU unless ``--device cpu`` is
given.  ``--smoke`` selects the reduced config; ``--approx`` enables the
MCMA ApproxFFN layer (with its tick-router head; an MoE architecture
trains its MoE instead).  The port trains every architecture that reads
tokens; ``--mesh`` comes with ROADMAP queue 1, item 14.
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
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.approx:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True))
    if args.mesh:
        raise NotImplementedError("--mesh: a training mesh is not ported "
                                  "yet (ROADMAP queue 1, item 14)")

    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq_len,
                     global_batch=args.batch, seed=args.seed)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, base_lr=args.lr,
                       warmup=max(args.steps // 10, 1),
                       grad_accum=args.grad_accum)
    out = Trainer(cfg, tc, ds, seed=args.seed, device=args.device).run()
    print(f"done: {out}")
    return out


if __name__ == "__main__":
    main()
