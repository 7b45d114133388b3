"""Small cells for the CPU tests: a configuration's family at a tiny
width in float32, with short traffic."""
import copy
import json
from pathlib import Path


class StepClock:
    """A clock that moves ``step`` seconds each time it is read: the open
    loop then batches the same way on any machine, however loaded."""

    def __init__(self, step: float = 0.005):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

BENCH = Path(__file__).resolve().parents[1]


def tiny(config: str, mix: str, backend: str = "xla", rate: float = 40.0,
         batch: int = 4) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    cfg.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab=4096, param_dtype="float32", act_dtype="float32")
    cfg["approx"] = dict(cfg["approx"], d_hidden=32, backend=backend,
                         block_t=16)
    cfg["check"] = dict(cfg["check"], sample_tokens=60, sample_requests=4)
    m = copy.deepcopy(m)
    m["preroll_s"] = 0.3
    m["arrivals"]["rate_per_s"] = rate
    for k, hi in (("prompt_len", 40), ("output_len", 12)):
        m[k] = dict(m[k], median=min(m[k]["median"], hi // 2), min=2,
                    max=hi)
    serve = dict(m["serve"], batch=batch, max_len=64)
    if "prefill_chunk" in serve:
        serve.update(prefill_chunk=8, kv_page_size=8,
                     kv_pages=batch * 64 // 8)
    m["serve"] = serve
    return dict(name=f"tiny-{config}", chips=1, config=cfg, traffic=m,
                end_to_end=[], per_layer=[])
