"""dropped_frac: the share (%) of the window's decode-tick rows routed to
a class and served by none for lack of the class's capacity (their FFN
adds zero), from the server's counters."""


def read(run):
    c0, c1 = run["c0"], run["c1"]
    if c1["routed"] is None:
        return None
    r0 = 0 if c0["routed"] is None else c0["routed"]
    rows = float((c1["routed"] - r0).sum())
    return 100.0 * (c1["dropped"] - c0["dropped"]) / rows if rows else None
