"""itl_p95_ms: the 95th percentile over every gap between consecutive
output tokens of a request that ends in the window."""
from h100_bench import stats


def read(run):
    v = stats.p95(stats.itl_values([r.tokens for r in run["reqs"].values()],
                                   run["w0"], run["w1"]))
    return None if v is None else v * 1e3
