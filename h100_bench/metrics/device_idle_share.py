"""device_idle_share: the share (%) of the traced stretch in which no
device operation ran."""
from h100_bench.metrics import _trace


def read(run):
    tr = run["trace"]
    if tr is None or not len(tr["names"]):
        return None
    busy, length = _trace.busy(tr)
    return 100.0 * (1.0 - busy / length) if length > 0 else None
