"""Serving runtime: the public API lives here (counterpart of
``repro/runtime/__init__.py``, the same 19 names), pinned by
tests/test_torch_public_api.py.  The canonical deployment:

    from repro_torch.runtime import DecodeServer, ServeOptions, LibrarySpec

    server = DecodeServer(cfg, params, options=ServeOptions(
        batch=8, use_mcma_dispatch=True, autotune=True,
        library=LibrarySpec(library_size=16, n_resident=4)))

The names resolve on first use (PEP 562): the model imports
``runtime.dispatch``, and an eager import of the server here would close
an import cycle through ``runtime.steps``.
"""
import importlib

_EXPORTS = {
    "add_serve_options": "cli",
    "DispatchPlan": "dispatch", "InvokeStats": "dispatch",
    "execute_dispatch": "dispatch", "make_dispatch_plan": "dispatch",
    "mcma_dispatch": "dispatch", "plan_invoke_stats": "dispatch",
    "LibrarySpec": "options", "ServeOptions": "options",
    "CapacityController": "autotune", "OperatingPoint": "autotune",
    "ResidencyController": "autotune", "Swap": "autotune",
    "Switch": "autotune", "default_ladder": "autotune",
    "ladder_from_counts": "autotune",
    "DecodeServer": "server", "DrainStats": "server", "Request": "server",
}

__all__ = sorted(_EXPORTS, key=lambda n: (n[0].islower(), n))


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
