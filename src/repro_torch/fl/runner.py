"""One-shot runner entry point over the FleetEngine (port of
``repro.fl.runner``)."""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import FederatedClassification
from repro_torch.fl.engine import FleetEngine, History
from repro_torch.fl.simulator import Fleet, SimConfig


def run_fl(policy_name: str, data: FederatedClassification,
           sim_cfg: SimConfig, fl_cfg: FLConfig,
           fleet: Optional[Fleet] = None, eval_every: int = 1,
           time_budget: Optional[float] = None,
           progress: Optional[Callable] = None, device=None) -> History:
    """One-shot FL run: engine construction + ``engine.run`` in one call.
    Runs on the CUDA card unless ``device`` names another."""
    engine = FleetEngine(data, sim_cfg, fl_cfg, fleet=fleet, device=device)
    return engine.run(policy_name, time_budget=time_budget,
                      eval_every=eval_every, progress=progress)
