"""admit_wait_ms: the mean over requests admitted in the untraced window
of due time to the start of the tick that took them into a slot."""


def read(run):
    w0, end = run["w0"], run["host_end"]
    v = [r.admit - r.due for r in run["reqs"].values()
         if r.admit is not None and w0 <= r.admit < end]
    return 1e3 * sum(v) / len(v) if v else None
