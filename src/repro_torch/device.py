"""The device rule shared by the port's entry points (``FleetEngine``,
``run_fl``, ``launch.serve``), and the one seam through which the FL
round loop waits for the card (``host_readback``)."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another.  Asked for the card on a machine without one, it
    raises rather than drift onto the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default and this "
            "machine has none; pass device='cpu' to run on the CPU")
    return device


_readback_depth = 0


def in_host_readback() -> bool:
    """Is the host inside a ``host_readback`` seam (on any device)?  The
    op checks of ``repro_torch.analysis.op_checks`` read it."""
    return _readback_depth > 0


@contextlib.contextmanager
def host_readback(device):
    """A deliberate wait of the host for ``device``: lifts ``torch.cuda``'s
    sync debug mode for its extent and restores it, so a run under
    ``set_sync_debug_mode("error")`` fails on any other wait for the
    card.  The FL round loop waits only through here: the round ledger's
    resolve, the run-end read-back, the offload stream's two reads a
    round (``core/cache_store.py``) and, under ``FLConfig.debug_checks``,
    the round guard's read."""
    global _readback_depth
    _readback_depth += 1
    try:
        if torch.device(device).type != "cuda":
            yield
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    finally:
        _readback_depth -= 1
