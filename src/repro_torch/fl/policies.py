"""Server policies of the port: FLUDE (paper §4, Algorithms 1–2).

The five comparison baselines of ``repro.fl.policies`` are ROADMAP Queue A
#8.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import round as R
from repro_torch.fl.api import (Policy, RoundObservation, RoundPlan,
                                RoundReport, register_policy, to_host)


class FludePolicyState(NamedTuple):
    core: R.FludeState
    last: Optional[R.FludePlan]     # plan pending its belief update


@register_policy("flude")
class FludePolicy(Policy):
    """The paper's policy: Beta-belief dependability selection (Alg. 1),
    adaptive staleness/quorum control (Alg. 2) and C3 cache resume,
    planned on the engine's device."""
    uses_cache = True

    def __init__(self, sim_cfg, fl_cfg, fleet=None, device="cpu"):
        super().__init__(sim_cfg, fl_cfg, fleet, device=device)
        # §4.1 optional: bias exploration toward charged/stable devices
        # (the host fp64 product, cast to float32 as in the reference)
        self._hints = None
        if fleet is not None:
            self._hints = torch.from_numpy(np.asarray(
                fleet.battery * fleet.stability, np.float32)
            ).to(self.device)

    def init_state(self) -> FludePolicyState:
        return FludePolicyState(R.init_state(self.fl_cfg, self.device), None)

    def plan(self, state, obs: RoundObservation):
        online = torch.from_numpy(np.asarray(obs.online, bool)
                                  ).to(self.device)
        uniforms = torch.tensor(np.asarray(obs.uniforms, np.float32),
                                device=self.device)
        p = R.plan_round(state.core, obs.caches, online, self.fl_cfg,
                         uniforms, explore_hints=self._hints)
        # quorum clamp: can't wait for more receipts than selections
        p = p._replace(quorum=torch.minimum(
            p.quorum, p.selected.sum().to(torch.float32)))
        plan = RoundPlan.create(p.selected, p.distribute, p.resume,
                                float(p.quorum))
        return FludePolicyState(state.core, p), plan

    def observe(self, state, plan, report: RoundReport):
        # Eq. 1 bookkeeping right away (the reference parks the receipts
        # and folds them into the next plan's dispatch: same update on the
        # same values)
        received = torch.from_numpy(np.asarray(report.received, bool)
                                    ).to(self.device)
        return FludePolicyState(
            R.update_after_round(state.core, state.last, received,
                                 self.fl_cfg), None)

    def history_extras(self, state):
        return {"part_count": to_host(state.core.part_count)}
