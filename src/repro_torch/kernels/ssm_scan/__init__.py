"""Mamba2 SSD scan: ``ref`` (plain PyTorch), ``kernel`` (the CUDA launch)
and ``ops`` (the public wrapper)."""
