"""Name parity between the packages: every public function and class
defined in a module ``repro.X`` exists in ``repro_torch.X``, apart from
the written exceptions below, each with its reason (ROADMAP queue 3,
"Layout departures", and the items still to port).  An exception that
the port has since filled fails too, so the list only shrinks."""
import importlib
import inspect
import pathlib

import pytest

pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"

# whole modules the port does not have
MODULE_EXCEPTIONS = {
    "repro.analysis.rules.rl001_retrace":
        "not applicable: jit static_argnames and branches on closed-over "
        "values; the port compiles nothing, so it has no static arguments "
        "and an eager call re-reads every captured value",
    "repro.analysis.rules.rl003_pytree":
        "not applicable: pytree registration drift; the port has no "
        "pytrees (its plans and stats are plain dataclasses of tensors)",
    "repro.sharding.compat": "not applicable: it bridges jax versions of "
                             "shard_map, and the port has no shard_map",
}
# names of modules the port has
NAME_EXCEPTIONS = {
    ("repro.launch.hlo_cost", "Instr"):
        "no HLO text: the port records the op stream",
    ("repro.launch.hlo_cost", "parse_module"):
        "no HLO text: the port records the op stream",
    ("repro.analysis.opcount", "sub_jaxprs"):
        "not applicable: an eager call has no jaxpr to descend into; "
        "opcount counts the ops as they run",
    ("repro.models.approx_ffn", "approx_ffn_fwd"):
        "removed in the port: no caller (layout departure)",
    ("repro.models.layers", "init_norm"):
        "an nn.Module constructor (layers.Norm) under model.init_model",
    ("repro.models.layers", "init_embed"): "an nn.Module constructor (Embed)",
    ("repro.models.layers", "init_ffn"): "an nn.Module constructor (FFN)",
    ("repro.models.layers", "init_attn"):
        "an nn.Module constructor (Attention)",
    ("repro.models.mamba2", "init_mamba"): "an nn.Module constructor (Mamba)",
    ("repro.models.moe", "init_moe"): "an nn.Module constructor (MoE)",
    ("repro.models.xlstm", "init_mlstm"): "an nn.Module constructor (MLSTM)",
    ("repro.models.xlstm", "init_slstm"): "an nn.Module constructor (SLSTM)",
}


def _modules():
    for path in sorted((ROOT / "repro").rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__main__":
            continue
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _excepted_module(name):
    return next((m for m in MODULE_EXCEPTIONS
                 if name == m or name.startswith(m + ".")), None)


def _public(mod):
    return {n for n, o in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == mod.__name__}


MODULES = [m for m in _modules() if _excepted_module(m) is None]


@pytest.mark.parametrize("name", MODULES)
def test_port_has_every_public_name(name):
    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    want = _public(ref) | {n for m, n in NAME_EXCEPTIONS if m == name}
    missing = {n for n in want if not hasattr(port, n)}
    excepted = {n for m, n in NAME_EXCEPTIONS if m == name}
    assert missing == excepted, (
        f"missing and not excepted: {sorted(missing - excepted)}; "
        f"excepted but ported: {sorted(excepted - missing)}")


@pytest.mark.parametrize("name", sorted(MODULE_EXCEPTIONS))
def test_excepted_modules_are_still_missing(name):
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module("repro_torch" + name[len("repro"):])


def test_compression_is_ported():
    """optim/compression.py is no longer an exception."""
    port = importlib.import_module("repro_torch.optim.compression")
    for n in ("ef_int8_allreduce_tree", "init_error_feedback", "_quantize"):
        assert callable(getattr(port, n)), n
