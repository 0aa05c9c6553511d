"""PyTorch/CUDA port of the FLUDE reproduction (``repro``).

Same module layout as ``repro``; imports ``torch`` and numpy, never JAX and
nothing of ``repro``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``."""
