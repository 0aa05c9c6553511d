"""FLUDE core — the paper's contribution (C1–C5), as PyTorch modules."""
