"""Carry parameters between the JAX reference's layout and the port's.

The reference draws its initial parameters from threefry bits that the
port does not reproduce, so a parity test hands the reference's
parameters (as numpy) to the port.  The other way, ``lm_params_to_jax``
stacks the port's per-layer lists back into the reference's layout, in
which a language model's checkpoint is written, so each package
restores the other's files.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import LAYERED


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays (``jax.device_get`` of the reference's
    parameter tree) -> the port's nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def lm_params_from_jax(tree, num_layers: int, device="cpu"):
    """The reference's language-model parameters (numpy, from
    ``jax.device_get(model.init(key))``) -> the port's: the same dict,
    with each layered tree (``blocks``, ``mamba``, ``mamba_norm``)
    unstacked from its leading layer axis into a list of ``num_layers``
    per-layer dicts; ``shared_attn`` and ``ln0`` carried over as they
    are."""
    out = {k: params_from_jax(v, device) for k, v in tree.items()
           if k not in LAYERED}

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return _tensor(np.asarray(t)[i], device)

    for k in LAYERED:
        if k in tree:
            out[k] = [layer(tree[k], i) for i in range(num_layers)]
    return out


def _host(t: torch.Tensor):
    """A tensor as numpy, or as a CPU tensor where numpy has no such
    dtype (bfloat16)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def lm_params_to_jax(params):
    """The inverse of :func:`lm_params_from_jax`: the port's language-model
    parameters -> the reference's layout on the host, each layered list
    stacked back onto a leading layer axis; leaves are numpy arrays
    (bfloat16 ones CPU tensors, as numpy has no bfloat16)."""
    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([l[k] for l in layers]) for k in first}
        return _host(torch.stack(layers))

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        return _host(t)

    return {k: stack(v) if k in LAYERED else host(v)
            for k, v in params.items()}
