"""The paper's eight benchmark applications, Fig. 6 (counterpart of
``repro/apps``): each bundles the exact target function, an input
generator, the paper's approximator and classifier topologies, a default
error bound and the per-invocation CPU cost constant."""
from repro_torch.apps.registry import APPS, App, get_app, make_dataset

__all__ = ["APPS", "App", "get_app", "make_dataset"]
