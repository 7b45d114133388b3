"""Bessel deep-dive on the PyTorch port (the paper's 2D showcase, Figs.
9-11): the twin of ``examples/approx_bessel.py``.

Runs both MCMA allocation schemes, prints the per-iteration invocation
history (Fig. 9), each approximator's territory share (Fig. 10), and the
confusion quadrants (Fig. 11) — then pushes the dispatched test batch
through the switched-MLP weight switch (``ops.switched_apply``: the CUDA
kernel on the GPU, its PyTorch version on the CPU) under layers 0 and 1
of the three approximators, held to ``ref.switched_mlp_ref``.  Runs on
the GPU unless ``--device cpu``.

    python3 examples/approx_bessel_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.apps import APPS, make_dataset  # noqa: E402
from repro_torch.core import train_mcma  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def switch_stacks(m):
    """Layers 0 and 1 of each approximator, stacked: the weight switch's
    (w1, b1, w2, b2)."""
    return tuple(torch.stack([a[layer][k] for a in m.a_params])
                 for layer, k in ((0, "w"), (0, "b"), (1, "w"), (1, "b")))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--n-train", type=int, default=6_000)
    ap.add_argument("--n-test", type=int, default=2_000)
    ap.add_argument("--epochs", type=int, default=800)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    app = APPS["bessel"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    xtr, ytr, xte, yte = make_dataset(app, gen, args.n_train, args.n_test)

    for scheme in ("complementary", "competitive"):
        m = train_mcma(app, gen, xtr, ytr, n_approx=3, scheme=scheme,
                       iters=5, epochs=args.epochs)
        met = m.evaluate(xte, yte)
        print(f"\n== {scheme} ==")
        print("  invocation/iter:", " ".join(f"{v:.3f}" for v in m.history))
        print(f"  test: {met.row()}")
        print("  territory shares:", [f"{f:.3f}" for f in met.dispatch_frac])

    # ---- the weight-switch path through the switched-MLP kernel ----------
    cls = m.classify(xte)
    dispatched = cls < m.n_approx
    xd, cd = xte[dispatched], cls[dispatched]
    w = switch_stacks(m)
    got = ops.switched_apply(xd, cd, *w, block_t=128)
    want = ref.switched_mlp_ref(xd, cd, *w)
    err = float((got - want).abs().max()) if xd.shape[0] else 0.0
    print(f"\nswitched-MLP on {xd.shape[0]} dispatched inputs ({dev}): "
          f"max |kernel - ref| = {err:.2e}")
    assert err < 1e-4
    return m, err


if __name__ == "__main__":
    main()
