"""End-to-end LM training with the MCMA technique as a first-class layer,
on the PyTorch port: the twin of ``examples/train_lm_mcma.py``.

Trains a small LM (olmo-family wiring) with ApproxFFN enabled: every FFN
carries n approximators + an (n+1)-way router co-trained against the
exact FFN under an error bound.  Reports LM loss AND the paper's metric
— invocation (fraction of tokens routed off the exact path).  Runs on
the GPU unless ``--device cpu``.

Presets (the reference's):
    --preset smoke     ~1M params, 30 steps
    --preset 20m       ~20M params, 200 steps
    --preset 100m      ~100M params, 300 steps

    python3 examples/train_lm_mcma_torch.py --preset smoke [--steps N]
        [--ckpt-dir D] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import ApproxConfig, ModelConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

PRESETS = {
    "smoke": dict(n_layers=2, d_model=64, n_heads=4, d_ff=256, vocab=512,
                  seq=64, batch=8, steps=30, d_hidden=32),
    "20m": dict(n_layers=6, d_model=384, n_heads=6, d_ff=1536, vocab=8192,
                seq=256, batch=8, steps=200, d_hidden=64),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, d_ff=3072,
                 vocab=32768, seq=512, batch=16, steps=300, d_hidden=128),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    p = PRESETS[args.preset]
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = ModelConfig(
        name=f"lm-mcma-{args.preset}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_heads"], d_ff=p["d_ff"], vocab=p["vocab"],
        norm="rmsnorm", act="silu", gated_ffn=True,
        param_dtype="float32", act_dtype="float32", remat=False,
        q_block=64, kv_block=64,
        approx=ApproxConfig(enable=True, n_approx=3, d_hidden=p["d_hidden"],
                            error_bound=0.15, router_weight=0.05,
                            distill_weight=1.0))
    n_params = sum(x.numel() for x in
                   M.Model(cfg, torch.device("meta")).parameters())
    print(f"preset={args.preset}: {n_params / 1e6:.1f}M params "
          f"(incl. {cfg.approx.n_approx} approximators/layer + router)")

    ds = SyntheticLM(vocab=cfg.vocab, seq_len=p["seq"],
                     global_batch=p["batch"])
    steps = args.steps or p["steps"]
    tc = TrainerConfig(total_steps=steps, ckpt_every=max(steps // 3, 10),
                       ckpt_dir=args.ckpt_dir, base_lr=1e-3,
                       warmup=max(steps // 10, 1), log_every=10)
    trainer = Trainer(cfg, tc, ds, device=dev)
    out = trainer.run()
    # final: measure invocation on a fresh batch
    batch = {k: v.to(dev) for k, v in ds.batch_at(10_000).items()}
    with torch.no_grad():
        _, metrics = M.lm_loss(cfg, trainer.state["params"],
                               batch["inputs"], batch["labels"])
    print(f"final: loss={out['final_loss']:.4f} "
          f"invocation={float(metrics.get('invocation', 0.0)):.3f} "
          f"router_acc={float(metrics.get('router_acc', 0.0)):.3f}")
    first = trainer.history[0]["loss"] if trainer.history else float("nan")
    print(f"loss {first:.3f} -> {out['final_loss']:.3f} over "
          f"{out['steps']} steps")
    return dict(out, invocation=float(metrics.get("invocation", 0.0)),
                first_loss=first)


if __name__ == "__main__":
    main()
