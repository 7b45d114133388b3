"""off_set_exact_share: the share (%) of the window's decode-tick rows that
the router sent to a library class not resident at the time, served by
the exact FFN, over the rows routed, from the server's counters."""


def read(run):
    c0, c1 = run["c0"], run["c1"]
    if c1["lib"] is None:
        return None
    l0 = 0 if c0["lib"] is None else c0["lib"]
    rows = float((c1["lib"] - l0).sum())
    return 100.0 * (c1["off_set"] - c0["off_set"]) / rows if rows else None
