"""Roofline report (counterpart of ``repro/launch/roofline.py``):
aggregates runs/dryrun/*.json into the markdown table of the H100
roofline.

    python -m repro_torch.launch.roofline [--dir runs/dryrun] [--tag TAG]

Per cell: the three terms (seconds, ``dryrun.roofline_terms``), the
dominant bottleneck, the useful-FLOPs ratio (model FLOPs over the port's
FLOPs on every rank), a rank's peak bytes and whether they fit the
card's 80 GB, and a one-line lever for the port on this card.  A cell
the port refuses prints its refusal.  Markdown to stdout and
runs/roofline.md.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import Counter

from repro_torch.launch.dryrun import roofline_terms

LEVERS = {
    "compute": "fewer FLOPs the model does not need: skip the causal "
               "block pairs above the diagonal in flash_attention (it "
               "computes, then masks them), fewer remat recomputes, less "
               "tensor parallelism per card",
    "memory": "fewer passes over device memory: fuse the eager op stream "
              "(attention's f32 elementwise passes, the norms, the "
              "dispatch's gather and scatter: the fused switch kernel) "
              "into hand-written kernels",
    "collective": "reduce-scatter + all-gather instead of all_reduce_sum's "
                  "gather of every part; a model axis of at most 8 ranks "
                  "so tensor parallelism stays on NVLink; fewer, larger "
                  "collectives (the FSDP gathers per layer)",
}


def load_cells(dir_: str, tag: str = ""):
    cells = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        name = os.path.basename(path)[:-5]
        parts = name.split("__")
        cell_tag = parts[3] if len(parts) > 3 else ""
        if cell_tag != tag:
            continue
        with open(path) as f:
            d = json.load(f)
        if d.get("ok"):
            d["roofline"] = roofline_terms(d)
        cells.append(d)
    return cells


def fmt_table(cells, mesh="single"):
    rows = [c for c in cells if c["mesh"] == mesh]
    out = ["| arch | shape | compute s | memory s | coll s | bound | "
           "useful | peak GiB | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|"]
    for c in sorted(rows, key=lambda c: (c["arch"], c["shape"])):
        if not c.get("ok"):
            out.append(f"| {c['arch']} | {c['shape']} | REFUSED: "
                       f"{_reason(c.get('error', '?'))} | | | | | | |")
            continue
        r = c["roofline"]
        out.append(
            f"| {c['arch']} | {c['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"{r['bottleneck'][:4]} | {r['useful_flops_ratio']:.2f} | "
            f"{c['memory']['peak_bytes'] / 2**30:.1f} | "
            f"{'Y' if c['fits_80g'] else 'N'} |")
    return "\n".join(out)


def _reason(error: str) -> str:
    """A refusal's gist: which widths the mesh does not divide."""
    for key in ("does not divide", "do not divide"):
        i = error.find(key)
        if i >= 0:
            tail = error[i:]
            return tail[:tail.find(": the reference")].replace("|", "/") \
                if ": the reference" in tail else tail[:120]
    return error[:120].replace("|", "/")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="runs/roofline.md")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir, args.tag)
    ok = [c for c in cells if c.get("ok")]
    lines = [f"# H100 roofline ({len(ok)}/{len(cells)} cells ok, "
             f"tag='{args.tag}')", ""]
    for mesh in ("single", "multi"):
        sub = [c for c in cells if c["mesh"] == mesh]
        if not sub:
            continue
        lines += [f"## mesh = {mesh} ({sub[0]['chips']} cards)", "",
                  fmt_table(cells, mesh), ""]
    hist = Counter(c["roofline"]["bottleneck"] for c in ok)
    lines += [f"Bottlenecks: {dict(hist)}", ""]
    worst = sorted((c for c in ok if c["mesh"] == "single"),
                   key=lambda c: c["roofline"]["roofline_frac"])[:5]
    lines += ["Worst roofline fraction (single):"]
    for c in worst:
        r = c["roofline"]
        lines.append(f"- {c['arch']} {c['shape']}: frac={r['roofline_frac']:.3f}"
                     f" bound={r['bottleneck']} -> {LEVERS[r['bottleneck']]}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")


if __name__ == "__main__":
    main()
