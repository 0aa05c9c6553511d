"""The one rule for a kernel wrapper under autograd.

A ctypes launch is invisible to autograd: its output has no
``grad_fn``.  So a wrapper whose kernel has no backward yet, called
under grad with an input that requires it, raises rather than hand back
an output that would silently carry no gradient.
"""
from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Whether an output of ``tensors`` would need a gradient: grad mode
    is on and one of them (None skipped) requires it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# the bf16 backward kernel of rwkv6_scan (flash_attention and ssm_scan
# have theirs)
BF16_BACKWARD = "ROADMAP Queue A #15g step 3"
# fed_agg and residual_norms: no caller differentiates them
SERVER_STEP_ONLY = ("no backward is planned: the FL server step runs "
                    "under torch.no_grad()")


def refuse_grad(name: str, *tensors, why: str = BF16_BACKWARD):
    """Raise ``NotImplementedError`` where ``needs_grad(*tensors)``;
    ``name`` says which kernel (and variant) has no backward, ``why``
    which ROADMAP item brings one (or why none is planned)."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel; its output would carry no "
            f"gradient.  Run under torch.no_grad(), or pass impl='torch' / "
            f"ExecConfig(attn_impl='torch') to train through the plain "
            f"version ({why})")
