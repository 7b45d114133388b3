"""step_mfu: the exact dense model's forward FLOP of every position the
untraced window processed (prompt positions actually prefilled and
decoded tokens, each over its real context; logits on decode ticks), over
that time, as a share (%) of the chip's bf16 peak.  The count is the same
whatever the MCMA FFN served."""
from h100_bench import work


def read(run):
    w0, end = run["w0"], run["host_end"]
    flops = 0
    for (t0, _, ph), tk in zip(run["times"], run["ticks"]):
        if not w0 <= t0 < end:
            continue
        for _, _, start, n in tk.rows.tolist():
            flops += work.span_flops(run["cfg"], start, n, ph == "decode")
    if not flops or end <= w0:
        return None
    return 100.0 * flops / (end - w0) / work.PEAK_BF16_FLOPS
