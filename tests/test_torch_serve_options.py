"""The port's serving options (``runtime/options.ServeOptions``,
``runtime/cli.add_serve_options``) held to the reference's: the
non-legacy cases of tests/test_serve_options.py, each on the same argv
in both packages with equal options; ``from_args(args, mesh=...)``; the
launcher's ``--data`` / ``--model`` flags; the ``DrainStats`` mapping
protocol.  (The reference's legacy-kwarg shim is not ported.)"""
import argparse
import dataclasses

import pytest

pytest.importorskip("jax")
from repro.runtime.cli import add_serve_options as jadd  # noqa: E402
from repro.runtime.options import ServeOptions as JOptions  # noqa: E402

from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.runtime.cli import add_serve_options  # noqa: E402
from repro_torch.runtime.options import LibrarySpec, ServeOptions  # noqa: E402
from repro_torch.runtime.server import DrainStats  # noqa: E402


def _parse(add, argv, **defaults):
    ap = argparse.ArgumentParser()
    add(ap, **defaults)
    return ap.parse_args(argv)


ARGVS = [
    [],
    ["--qos"],
    ["--qos-app", "fft"],
    ["--tier-bounds", "0.02,0.05,0.1"],
    ["--autotune", "--drop-budget", "0.1"],
    ["--library-size", "16", "--n-resident", "4"],
    ["--library-size", "2"],
    ["--library-size", "16"],
    ["--n-resident", "4"],
    ["--mcma-dispatch", "--backend", "pallas_fused", "--route-scope",
     "tick", "--prefill-chunk", "64", "--kv-page-size", "16",
     "--kv-pages", "128", "--admission", "fifo", "--overflow", "trim"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "bare")
def test_from_args_matches_reference(argv):
    o = ServeOptions.from_args(_parse(add_serve_options, argv))
    jo = JOptions.from_args(_parse(jadd, argv))
    assert dataclasses.asdict(o) == dataclasses.asdict(jo)


def test_from_args_defaults_match_field_defaults():
    o = ServeOptions.from_args(_parse(add_serve_options, []))
    # a bare parse is a bare ServeOptions up to the CLI-side defaults
    # (the CLI turns chunked prefill on)
    assert o == dataclasses.replace(ServeOptions(), batch=o.batch,
                                    max_len=o.max_len, prefill_chunk=16)
    assert o.use_mcma_dispatch is False and o.library is None


def test_from_args_implications():
    p = lambda argv: ServeOptions.from_args(_parse(add_serve_options, argv))
    o = p(["--qos"])
    assert o.qos_tiers is True and o.use_mcma_dispatch
    o = p(["--qos-app", "fft"])
    assert o.qos_app == "fft" and o.qos_tiers is True
    o = p(["--tier-bounds", "0.02,0.05,0.1"])
    assert o.qos_tiers == (0.02, 0.05, 0.1) and o.use_mcma_dispatch
    o = p(["--autotune"])
    assert o.autotune is True and o.use_mcma_dispatch
    o = p(["--library-size", "16", "--n-resident", "4"])
    assert o.library == LibrarySpec(library_size=16, n_resident=4)
    assert o.use_mcma_dispatch
    assert p(["--library-size", "2"]).library.n_resident == 2
    assert p(["--library-size", "16"]).library.n_resident == 4
    o = p(["--n-resident", "4"])
    assert o.library is None and not o.use_mcma_dispatch


def test_from_args_overrides_win():
    mesh = object()
    o = ServeOptions.from_args(_parse(add_serve_options, ["--batch", "2"]),
                               batch=32, mesh=mesh)
    jo = JOptions.from_args(_parse(jadd, ["--batch", "2"]), batch=32,
                            mesh=mesh)
    assert o.batch == jo.batch == 32 and o.mesh is jo.mesh is mesh


def test_launcher_mesh_flags():
    """``--data`` / ``--model`` with the reference launcher's defaults (no
    mesh; model 1), folded into the options' mesh by the launcher."""
    args = launch_serve.build_parser().parse_args([])
    assert (args.data, args.model) == (0, 1)
    args = launch_serve.build_parser().parse_args(
        ["--data", "4", "--model", "2", "--batch", "8", "--mcma-dispatch"])
    assert (args.data, args.model, args.batch) == (4, 2, 8)
    mesh = object()
    o = ServeOptions.from_args(args, mesh=mesh)
    assert o.mesh is mesh and o.use_mcma_dispatch and o.batch == 8


def test_add_serve_options_rejects_unknown_default():
    with pytest.raises((AssertionError, ValueError, TypeError)):
        add_serve_options(argparse.ArgumentParser(), not_a_flag=3)


def test_serve_options_frozen():
    o = ServeOptions()
    with pytest.raises(dataclasses.FrozenInstanceError):
        o.batch = 4


def test_drain_stats_mapping_protocol():
    s = DrainStats(ticks=7, wall_s=1.5)
    assert s["ticks"] == 7 and "ticks" in s
    assert "invocation_rate" not in s          # None fields are absent
    with pytest.raises(KeyError):
        s["invocation_rate"]
    s["invocation_rate"] = 0.25                # field write
    s["replay_wall_s"] = 2.0                   # unknown key -> extras
    assert s.invocation_rate == 0.25
    assert s["replay_wall_s"] == 2.0 and "replay_wall_s" in s
    d = s.asdict()
    assert d["ticks"] == 7 and d["replay_wall_s"] == 2.0
    assert "dropped_rows" not in d             # still-None fields skipped
    assert s.get("missing", "dflt") == "dflt"
    assert set(d) == set(dict(s.items()))
