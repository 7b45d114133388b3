"""The port's serving public API (``repro_torch.runtime``) held to the
reference's (``repro.runtime``, snapshotted by tests/test_public_api.py):
the same ``__all__``, the same field tuples of ``ServeOptions``,
``LibrarySpec``, ``InvokeStats`` and ``DrainStats`` in order, frozen
value objects, ``options`` keyword-only on ``DecodeServer``, and the
kernels package's ``ops`` and ``ref``."""
import dataclasses
import inspect

import pytest

jrt = pytest.importorskip("repro.runtime")
import repro.kernels as jkernels  # noqa: E402

import repro_torch.kernels as kernels  # noqa: E402
import repro_torch.runtime as rt  # noqa: E402


def _fields(cls):
    return tuple(f.name for f in dataclasses.fields(cls))


def test_runtime_all_matches_reference():
    assert tuple(rt.__all__) == tuple(jrt.__all__)
    for name in rt.__all__:
        assert getattr(rt, name, None) is not None, name


@pytest.mark.parametrize("name", ["ServeOptions", "LibrarySpec",
                                  "InvokeStats", "DrainStats"])
def test_field_tuples_match_reference(name):
    assert _fields(getattr(rt, name)) == _fields(getattr(jrt, name))


def test_value_objects_are_frozen():
    for cls in (rt.ServeOptions, rt.LibrarySpec, rt.InvokeStats):
        assert cls.__dataclass_params__.frozen, cls.__name__


def test_canonical_constructor_shape():
    """The documented deployment spelling type-checks end to end."""
    o = rt.ServeOptions(batch=8, use_mcma_dispatch=True,
                        library=rt.LibrarySpec(library_size=16,
                                               n_resident=4))
    assert o.library.initial_residency() == (0, 1, 2, 3)
    sig = inspect.signature(rt.DecodeServer.__init__)
    assert sig.parameters["options"].kind is inspect.Parameter.KEYWORD_ONLY
    assert dataclasses.asdict(rt.ServeOptions()) == \
        dataclasses.asdict(jrt.ServeOptions())


def test_kernels_package_exports_ops_and_ref():
    assert tuple(kernels.__all__) == tuple(jkernels.__all__) == ("ops", "ref")
    assert kernels.ops.switched_apply and kernels.ref
