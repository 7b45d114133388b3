"""The control on the card: the reference put in the program's place in
float8 must fail the limit where the served bf16 program passes it, at a
size a test run holds (each configuration whole, on 32 slots at a
quarter of the cell's rate, a 20 s window after the mix's pre-roll; the
full-size readings are control.py's, in PERF.md).
Needs a CUDA device: run on the card with
``python -m pytest -q -m cuda h100_bench/tests``."""
import json
import time
from pathlib import Path

import pytest
import torch

from h100_bench import harness

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the switch kernel has no CPU mode")
    return torch.device("cuda:0")


def _cell(config, mix):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    m["serve"]["batch"] = 32
    if "kv_pages" in m["serve"]:
        m["serve"]["kv_pages"] = 32 * m["serve"]["max_len"] \
            // m["serve"]["kv_page_size"]
    m["arrivals"]["rate_per_s"] /= 4
    return dict(name=config, chips=1, config=cfg, traffic=m, end_to_end=[],
                per_layer=[])


@pytest.mark.cuda
@pytest.mark.parametrize("config,mix", [("internlm2-1.8b", "chat"),
                                        ("internlm2-1.8b", "chat-tiers")])
def test_float8_control_fails_where_bf16_passes(cuda, config, mix):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cell = _cell(config, mix)
    limit = cell["config"]["check"]["gap_limit"]
    for seed in (101, 2 ** 31 + 3, 4_000_000_001):
        with torch.no_grad():
            line = harness.run_cell(cell, seed, 20.0, False, cuda,
                                    time.perf_counter(), control=True)
        x = line["_extra"]
        assert x["tokens"] >= 300 and x["undecided"] == 0, x
        assert x["gap"] <= limit < x["control_gap"], x
