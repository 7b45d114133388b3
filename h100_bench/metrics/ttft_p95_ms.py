"""ttft_p95_ms: the 95th percentile over every request due in the window
of due time to first token; one with none by the window's end counts the
time it waited."""
from h100_bench import stats


def read(run):
    reqs = list(run["reqs"].values())
    v = stats.p95(stats.ttft_values(
        [r.due for r in reqs], [r.tokens[0] if r.tokens else None
                                for r in reqs], run["w0"], run["w1"]))
    return None if v is None else v * 1e3
