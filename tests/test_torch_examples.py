"""The last two example twins on the CPU, at their smoke presets:
``examples/train_lm_mcma_torch.py`` (its 30 steps cut to 6 with
``--steps``) and ``examples/serve_decode_torch.py`` (the reference
example's smoke config and 10-request wave, here 4 requests)."""
import importlib.util
import math
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-sized models: one torch thread, so that the test does not
    contend with the other test processes of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_mcma_twin_trains_on_cpu():
    out = _load("train_lm_mcma_torch").main(
        ["--preset", "smoke", "--steps", "6", "--device", "cpu"])
    assert out["steps"] == 6 and math.isfinite(out["final_loss"])
    assert out["final_loss"] < out["first_loss"]
    assert 0.0 <= out["invocation"] <= 1.0


@pytest.mark.parametrize("flags", [[], ["--approx", "--mcma-dispatch"]],
                         ids=["exact", "mcma"])
def test_serve_decode_twin_serves_on_cpu(flags):
    stats = _load("serve_decode_torch").main(
        ["--device", "cpu", "--requests", "4", *flags])
    assert stats["ticks"] > 0 and stats["undrained_inflight"] == 0
    if flags:
        assert 0.0 <= stats["invocation_rate"] <= 1.0
