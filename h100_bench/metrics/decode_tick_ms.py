"""decode_tick_ms: host time of every decode tick started in the untraced
window, over their number."""


def read(run):
    w0, end = run["w0"], run["host_end"]
    v = [t1 - t0 for t0, t1, ph in run["times"]
         if ph == "decode" and w0 <= t0 < end]
    return 1e3 * sum(v) / len(v) if v else None
