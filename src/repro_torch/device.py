"""The device rule shared by the port's entry points (``FleetEngine``,
``run_fl``, ``launch.serve``)."""
from __future__ import annotations

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
