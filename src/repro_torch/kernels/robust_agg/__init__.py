"""Robust aggregation: ``ref`` (oracles and plain PyTorch), ``kernel`` (the
CUDA ``residual_norms`` launch) and ``ops`` (the public wrappers)."""
