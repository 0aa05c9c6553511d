"""WKV6 scan: ``ref`` (plain PyTorch), ``kernel`` (the CUDA launch) and
``ops`` (the public wrappers)."""
