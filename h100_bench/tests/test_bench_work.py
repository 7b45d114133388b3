"""The yardstick's counts against hand counts at the configuration's
published widths."""
import json
from pathlib import Path

from h100_bench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_internlm2_token_flops():
    c = _cfg("internlm2-1.8b")
    per_layer = 2 * 2048 * (16 + 2 * 8) * 128 + 2 * 2048 * 2048 \
        + 6 * 2048 * 8192
    assert per_layer == 125_829_120
    assert work.token_flops(c, 0, False) == 24 * per_layer
    assert work.token_flops(c, 100, False) \
        == 24 * (per_layer + 4 * 100 * 16 * 128)
    assert work.token_flops(c, 0, True) - work.token_flops(c, 0, False) \
        == 379_060_224


def test_span_flops_sums_the_tokens():
    c = _cfg("internlm2-1.8b")
    want = sum(work.token_flops(c, p + 1, False) for p in range(30, 70))
    assert work.span_flops(c, 30, 40, False) == want
    assert work.span_flops(c, 69, 1, True) == work.token_flops(c, 70, True)


def test_switch_work_and_bound():
    n_bytes, flops = work.switch_work(96, 2048, 256, 2048, n_classes=3,
                                      itemsize=2, index_bytes=4 * 96)
    assert (n_bytes, flops) == (7_092_096, 201_326_592)
    c = _cfg("internlm2-1.8b")
    b = work.switch_bound_s([32, 40, 30, 26], c)
    nb, fl = work.switch_work(96, 2048, 256, 2048, n_classes=3, itemsize=2,
                              index_bytes=4 * 96)
    assert b == max(nb / 3.35e12, fl / 989e12)
    assert work.switch_bound_s([128, 0, 0, 0], c) == 0.0
    # only the classes that got rows load their weights
    one = work.switch_bound_s([100, 28, 0, 0], c)
    assert one < b
