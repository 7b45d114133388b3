"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).
The cell, its configuration, its traffic mix and its metrics are read
from ``BENCHMARK.json`` and ``h100_bench/``.  Needs as many CUDA devices
as the cell asks for; exits non-zero, printing no result, without them,
without the port, or if JAX or the JAX package was loaded.  The last line
on standard output is the result's JSON object; the compared numbers and
their limits are also the last lines on standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"


def _env():
    """Every cache the program or its libraries keep, at fixed paths in the
    checkout; torch on few threads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden(modules) -> list:
    """Top-level names of loaded modules that are JAX, its libraries or the
    JAX package, compared whole."""
    from h100_bench.harness import FORBIDDEN
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    from h100_bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here without the port)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce in float32, as the configurations state
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    with torch.no_grad():
        line = harness.run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda:0", T_START)
    extra = line.pop("_extra")
    bad = loaded_forbidden(sys.modules)
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    print(f"sample: {extra['sample']} requests, {extra['tokens']} tokens",
          file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
