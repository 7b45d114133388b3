"""Quickstart on the PyTorch port: the paper's pipeline end to end.

Trains one-pass / iterative / MCMA on Black-Scholes (reduced sizes),
prints the invocation + error table (the paper's headline comparison),
and the NPU cost model's speedup estimate: the twin of
``examples/quickstart.py``.  Runs on the GPU unless ``--device cpu``.

    python3 examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.apps import APPS, make_dataset  # noqa: E402
from repro_torch.core import (npu_model, train_iterative,  # noqa: E402
                              train_mcma, train_one_pass)
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--n-train", type=int, default=4_000)
    ap.add_argument("--n-test", type=int, default=2_000)
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    app = APPS["blackscholes"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    xtr, ytr, xte, yte = make_dataset(app, gen, args.n_train, args.n_test)

    print(f"app={app.name} error_bound={app.error_bound} device={dev}")
    ep = args.epochs
    models = {
        "one-pass": train_one_pass(app, gen, xtr, ytr, epochs=ep),
        "iterative": train_iterative(app, gen, xtr, ytr, epochs=ep),
        "mcma-competitive": train_mcma(app, gen, xtr, ytr, n_approx=3,
                                       scheme="competitive", epochs=ep),
    }
    base = None
    for name, m in models.items():
        met = m.evaluate(xte, yte)
        cost = npu_model.cost(app, met.invocation,
                              n_approx=3 if "mcma" in name else 1,
                              multiclass="mcma" in name)
        if base is None:
            base = cost
        print(f"{name:18s} invocation={met.invocation:.3f} "
              f"err/bound={met.err_norm:.3f} "
              f"speedup-vs-onepass={cost.speedup_vs(base):.2f}x "
              f"energy-red={cost.energy_reduction_vs(base):.2f}x")
    return models


if __name__ == "__main__":
    main()
