"""Carry parameters over from the JAX reference.

A test hook: the reference draws its initial classifier from threefry
bits that the port does not reproduce, so a parity test hands the
reference's parameters (as numpy) to ``FleetEngine(template=...)``.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays (``jax.device_get`` of the reference's
    parameter tree) -> the port's nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)
