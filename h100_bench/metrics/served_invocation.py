"""served_invocation: the share (%) of the window's FFN rows that an
approximator served, from the server's own counters: on decode ticks the
rows dispatched to an approximator class over the rows routed; on chunk
ticks, whose per-class rows the server does not read, the tick's routed
invocation weighted by its tokens."""


def read(run):
    c0, c1 = run["c0"], run["c1"]
    if c1["routed"] is None:
        return None
    d0 = 0 if c0["dispatched"] is None else c0["dispatched"]
    r0 = 0 if c0["routed"] is None else c0["routed"]
    served = float((c1["dispatched"] - d0)[1:].sum()) \
        + c1["prefill_inv"] - c0["prefill_inv"]
    rows = float((c1["routed"] - r0).sum()) \
        + c1["prefill_tokens"] - c0["prefill_tokens"]
    return 100.0 * served / rows if rows else None
