"""output_tokens_per_s: every output token stamped in the window, over its
length."""
from h100_bench import stats


def read(run):
    return stats.output_tokens_per_s([r.tokens for r in run["reqs"].values()],
                                     run["w0"], run["w1"])
