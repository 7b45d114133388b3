"""Core MLP substrate (counterpart of ``repro/core``): ``mlp.MLPSpec``."""
