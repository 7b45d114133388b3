"""Read the two numbers that a cell's correctness limit is set from, on
the chip at the cell's own size and load: for each seed, one run of the
cell (``--seconds`` of its traffic) judged by the reference, giving the
program's widest logit gap, and the control's gap on the same requests:
the reference put in the program's place with every weight matrix in
float8 (e4m3, one scale a tensor), routing by its own weights.  One
process, one JSON line a seed.

    python3 h100_bench/control.py --workload <cell> --seconds <s> \
        --seeds 11,12,13
"""
import argparse
import time
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from h100_bench import run as bench_run  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    bench_run._env()
    import torch
    from h100_bench import harness
    assert torch.cuda.is_available()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cell = harness.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        with torch.no_grad():
            line = harness.run_cell(cell, seed, args.seconds, False,
                                    "cuda:0", t, control=True)
        x = line["_extra"]
        print(json.dumps(dict(seed=seed, gap=x["gap"],
                              control_gap=x["control_gap"],
                              tokens=x["tokens"], requests=x["sample"],
                              undecided=x["undecided"],
                              seconds=time.perf_counter() - t)), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
