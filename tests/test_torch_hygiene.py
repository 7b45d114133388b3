"""Rules of the PyTorch port that hold without the reference: it (and its
example twins) imports neither ``jax`` nor the JAX package, its entry
points never drop to the CPU quietly, a serving or training mesh refuses
the layouts it does not divide (naming ROADMAP queue 3),
and the QoS, library and autotune options serve."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.runtime.options import LibrarySpec, ServeOptions
from repro_torch.runtime.server import DecodeServer, Request
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "examples").glob("*_torch.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _cfg():
    cfg = smoke_config(get_config("internlm2-1.8b"))
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))


def test_entry_points_without_device_raise_when_there_is_no_gpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    for call in (lambda: M.init_model(0, cfg),
                 lambda: M.init_cache(cfg, 2, 8),
                 lambda: params_from_jax(cfg, {}),
                 lambda: launch_serve.main(["--smoke", "--approx"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


class FakeMesh:
    """Duck-typed mesh: the refusals happen before any collective."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape)


# the options ported with QoS tiers, library residency and autotune
QOS_LIBRARY_AUTOTUNE = {"autotune": True, "qos_tiers": True,
                        "qos_app": "bessel",
                        "library": LibrarySpec(library_size=6, n_resident=2)}
SCHEDULER = {"kv_page_size": 4, "kv_pages": 8, "prefill_chunk": 4,
             "route_scope": "tick"}


# (arch, mesh, what the refusal names): every family serves and trains on
# a mesh, and a model axis that does not divide a width its tensor- or
# expert-parallel branch splits is a layout departure (queue 3): the smoke
# xLSTM's 4 heads over 3 (heads below |model| serve where |model| is a
# multiple of them, ROADMAP item 16b), the smoke hybrid's 8 Mamba2 heads
# and the smoke MoE's 4 experts over 3, whose d_ff of 128 does not divide
# either (experts that do not divide run TP-in-expert when each expert's
# d_ff does; the reference places the rest with the compiler)
FAMILY_REFUSALS = {
    "xlstm-heads-over-model": (
        "xlstm-1.3b", (1, 3), "heads=4, d_up=128.*ROADMAP queue 3"),
    "zamba2-mamba-heads-over-model": (
        "zamba2-2.7b", (1, 3), "Mamba2 heads=8.*ROADMAP queue 3"),
    "moe-experts-over-model": (
        "moonshot-v1-16b-a3b", (1, 3),
        r"d_ff \(experts=4, TP-in-expert\)=128.*ROADMAP queue 3"),
}


@pytest.mark.parametrize("case", sorted(FAMILY_REFUSALS))
def test_mesh_refuses_a_family_width_it_cannot_divide(case):
    """A model axis that does not divide the xLSTM's heads, the hybrid's
    Mamba2 heads or an MoE's experts is refused."""
    arch, shape, match = FAMILY_REFUSALS[case]
    cfg = smoke_config(get_config(arch))
    params = M.init_model(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        DecodeServer(cfg, params, options=ServeOptions(
            batch=4, mesh=FakeMesh(shape)))


@pytest.mark.parametrize("shape", [(3, 2), (1, 3)],
                         ids=["batch-over-data", "d_ff-over-model"])
def test_mesh_refuses_a_layout_it_cannot_divide(shape):
    """Where the sharded serve path's layout fails (d_ff and the heads over
    model; a batch below the data axes whose cache length, the server's
    max_len of 256, does not divide over them either) the reference
    falls back to compiler-placed sharding; the port refuses."""
    cfg = _cfg()
    params = M.init_model(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        DecodeServer(cfg, params, options=ServeOptions(
            batch=4, use_mcma_dispatch=True, mesh=FakeMesh(shape)))


@pytest.mark.parametrize("case", sorted(FAMILY_REFUSALS))
def test_train_mesh_refuses_a_family_width_it_cannot_divide(case):
    """A model axis that does not divide the xLSTM's heads, the hybrid's
    Mamba2 heads or an MoE's experts trains on neither ``Trainer(mesh=)``
    nor the launcher's ``--mesh`` (which refuses before it starts a
    rank)."""
    arch, shape, match = FAMILY_REFUSALS[case]
    cfg = smoke_config(get_config(arch))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=8, global_batch=4)
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, TrainerConfig(total_steps=1), ds,
                mesh=FakeMesh(shape), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        launch_train.main(["--arch", arch, "--smoke", "--steps", "1",
                           "--batch", "4", "--device", "cpu", "--mesh",
                           ",".join(map(str, shape))])


@pytest.mark.parametrize("shape,batch", [((3, 1), 4), ((1, 3), 6)],
                         ids=["batch-over-data", "heads-over-model"])
def test_train_mesh_refuses_a_layout_it_cannot_divide(shape, batch):
    """A mesh the microbatch's rows or sequence, the heads, the kv heads,
    d_ff or the vocab do not divide is refused, where the reference falls
    back to compiler-placed sharding (ROADMAP queue 3): 4 rows below 3
    data ranks train split by sequence over them only where the sequence
    divides over them (8 and 128 positions do not)."""
    cfg = _cfg()
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=8, global_batch=batch)
    seq = (lambda n: f"{n} positions over them.*") if shape[0] > 1 \
        else (lambda n: "")
    with pytest.raises(NotImplementedError,
                       match=seq(8) + "ROADMAP queue 3"):
        Trainer(cfg, TrainerConfig(total_steps=1), ds, mesh=FakeMesh(shape),
                device="cpu")
    with pytest.raises(NotImplementedError,
                       match=seq(128) + "ROADMAP queue 3"):
        launch_train.main(["--smoke", "--approx", "--steps", "1", "--batch",
                           str(batch), "--device", "cpu", "--mesh",
                           ",".join(map(str, shape))])


def test_train_mesh_without_device_raises_when_there_is_no_gpu(monkeypatch):
    """``--mesh`` without ``--device`` and without a GPU raises before any
    rank starts: no rank carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--smoke", "--approx", "--steps", "1",
                           "--mesh", "2,2"])


def test_no_refusal_names_the_training_mesh_item():
    """Item 14 (the training mesh) is done: no message of the port names
    it."""
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        assert "item 14" not in path.read_text(), path


def test_no_refusal_names_the_hybrid_and_xlstm_mesh_item():
    """Item 15 (the mesh for the hybrid and xLSTM families) is done: no
    message of the port names it."""
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        assert "item 15" not in path.read_text(), path


@pytest.mark.parametrize("field", sorted(QOS_LIBRARY_AUTOTUNE))
def test_qos_library_autotune_options_are_served(field):
    """The options that raised until QoS tiers, library residency and
    autotune were ported now serve a request."""
    cfg = _cfg()
    if field == "library":
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, library_size=6))
    opts = dataclasses.replace(ServeOptions(use_mcma_dispatch=True, batch=2,
                                            max_len=16),
                               **{field: QOS_LIBRARY_AUTOTUNE[field]})
    srv = DecodeServer(cfg, M.init_model(0, cfg, device="cpu"), options=opts)
    r = Request(rid=0, prompt=np.arange(1, 10), max_new=3)
    srv.submit(r)
    stats = srv.run_until_drained(100)
    assert r.done and len(r.out) == 3 and stats["undrained_inflight"] == 0
    key = {"autotune": "autotune", "qos_tiers": "per_tier",
           "qos_app": "per_tier", "library": "residency"}[field]
    assert key in stats


@pytest.mark.parametrize("field", sorted(SCHEDULER))
def test_scheduler_serve_options_are_served(field):
    """The options that raised until chunked prefill, the paged cache and
    tick scope were ported now serve a request."""
    cfg = _cfg()
    opts = dataclasses.replace(ServeOptions(use_mcma_dispatch=True, batch=2,
                                            max_len=16),
                               **{field: SCHEDULER[field]})
    srv = DecodeServer(cfg, M.init_model(0, cfg, device="cpu"), options=opts)
    r = Request(rid=0, prompt=np.arange(1, 10), max_new=3)
    srv.submit(r)
    stats = srv.run_until_drained(100)
    assert r.done and len(r.out) == 3 and stats["undrained_inflight"] == 0


def test_unported_archs_and_qos_requests_raise():
    cfg = _cfg()
    srv = DecodeServer(cfg, M.init_model(0, cfg, device="cpu"))
    # QoS is served now: a tiered request on a server without a tier
    # table is refused as the reference refuses it
    with pytest.raises(ValueError, match="no tier table"):
        srv.submit(Request(rid=0, prompt=np.ones(2), error_bound=0.1))


def test_launcher_serves_on_cpu():
    stats = launch_serve.main(["--smoke", "--approx", "--mcma-dispatch",
                               "--device", "cpu", "--requests", "3",
                               "--max-new", "4", "--batch", "2"])
    assert stats["ticks"] > 0 and 0.0 <= stats["invocation_rate"] <= 1.0
