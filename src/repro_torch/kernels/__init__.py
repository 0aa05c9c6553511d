"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Nothing is compiled at import: see ``_build``."""
