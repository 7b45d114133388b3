"""switched_mlp_roofline: over the traced decode ticks, the least time of
the weight switch's logical dispatch (``work.switch_bound_s`` at each
tick's dispatched rows per class, once per MCMA site) over the device time
of the ``switched_mlp`` kernels in those ticks, as a share (%).  Nothing
when the stretch ran no such kernel."""
import numpy as np

from h100_bench import work
from h100_bench.metrics import _trace


def read(run):
    tr = run["trace"]
    if tr is None or not len(tr["names"]):
        return None
    k, m = _trace.in_phase(tr, "decode")
    sw = np.array(["switched_mlp" in n for n in tr["names"]], bool) & m
    t = float(tr["dur"][sw].sum()) / 1e9
    if t <= 0:
        return None
    sites = work.mcma_sites(run["cfg"])
    bound = sum(work.switch_bound_s(d, run["cfg"]) * sites
                for d, ph in zip(tr["disp"], tr["phases"])
                if ph == "decode" and d is not None)
    return 100.0 * bound / t if bound > 0 else None
