"""decode_launches_per_tick: device operations that started inside the
traced decode ticks, over their number."""
from h100_bench.metrics import _trace


def read(run):
    tr = run["trace"]
    if tr is None or not len(tr["names"]) or not _trace.n_ticks(tr, "decode"):
        return None
    _, m = _trace.in_phase(tr, "decode")
    return int(m.sum()) / _trace.n_ticks(tr, "decode")
