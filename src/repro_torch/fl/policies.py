"""The six built-in server policies of the port: FLUDE (paper §4,
Algorithms 1–2) and the five comparison baselines of ``repro.fl.policies``
(random, oort, safa, fedsea, mifa, asyncfeded).

Each policy keeps its mutable per-run state in an explicit state returned
by ``init_state`` and threaded through ``plan``/``observe``.  FLUDE plans
on the engine's device; the baselines are host numpy, as in the
reference: on the device round loop they read the observation and the
report back with ``to_host``, which waits for the card at their own
boundary.  The states that carry a ``np.random.RandomState`` (random,
oort, safa, fedsea) advance it in place inside ``plan``, seeded and drawn
as the reference draws it, so a seed gives the reference's selections.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import round as R
from repro_torch.fl.api import (Policy, RoundObservation, RoundPlan,
                                RoundReport, register_policy, to_host)
from repro_torch.fl.simulator import place_per_client

BIG = 1 << 20


class FludePolicyState(NamedTuple):
    core: R.FludeState
    last: Optional[R.FludePlan]     # plan pending its belief update


@register_policy("flude")
class FludePolicy(Policy):
    """The paper's policy: Beta-belief dependability selection (Alg. 1),
    adaptive staleness/quorum control (Alg. 2) and C3 cache resume,
    planned on the engine's device."""
    uses_cache = True
    # Alg. 2 line 3 caps X at clients_per_round before budget shrinking
    selects_at_most_clients_per_round = True
    plans_on_device = True

    def __init__(self, sim_cfg, fl_cfg, fleet=None, device="cpu"):
        super().__init__(sim_cfg, fl_cfg, fleet, device=device)
        # §4.1 optional: bias exploration toward charged/stable devices
        # (the host fp64 product, cast to float32 as in the reference)
        self._hints = None
        if fleet is not None:
            self._hints = place_per_client(np.asarray(
                fleet.battery * fleet.stability, np.float32), self.device)

    def init_state(self) -> FludePolicyState:
        return FludePolicyState(R.init_state(self.fl_cfg, self.device), None)

    def plan(self, state, obs: RoundObservation):
        if obs.draw is not None:
            # device round loop: the online mask, the explore uniforms, the
            # plan and the quorum clamp stay on the device, and
            # RoundPlan.device checks structure only — planning reads
            # nothing back
            online, uniforms = obs.draw.online, obs.uniforms
        else:
            online = torch.from_numpy(np.asarray(obs.online, bool)
                                      ).to(self.device)
            uniforms = torch.tensor(np.asarray(obs.uniforms, np.float32),
                                    device=self.device)
        draws = None
        if self.fl_cfg.selection_mode == "thompson":
            belief = state.core.belief
            draws = obs.thompson(belief.alpha, belief.beta)
        p = R.plan_round(state.core, obs.caches, online, self.fl_cfg,
                         uniforms, explore_hints=self._hints,
                         thompson_draws=draws)
        # quorum clamp: can't wait for more receipts than selections
        p = p._replace(quorum=torch.minimum(
            p.quorum, p.selected.sum().to(torch.float32)))
        if obs.draw is not None:
            plan = RoundPlan.device(p.selected, p.distribute, p.resume,
                                    p.quorum)
        else:
            plan = RoundPlan.create(p.selected, p.distribute, p.resume,
                                    float(p.quorum))
        return FludePolicyState(state.core, p), plan

    def observe(self, state, plan, report: RoundReport):
        # Eq. 1 bookkeeping right away (the reference parks the receipts
        # and folds them into the next plan's dispatch: same update on the
        # same values)
        received = report.received
        if not isinstance(received, torch.Tensor):
            received = torch.from_numpy(np.asarray(received, bool))
        received = received.to(self.device)
        return FludePolicyState(
            R.update_after_round(state.core, state.last, received,
                                 self.fl_cfg), None)

    def history_extras(self, state):
        return {"part_count": to_host(state.core.part_count)}


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def _random_online(rs: np.random.RandomState, online, k: int,
                   N: int) -> np.ndarray:
    """(N,) bool: ``min(k, |online|)`` online clients drawn without
    replacement — the reference's ``choice`` over ``flatnonzero``."""
    sel = np.zeros(N, bool)
    idx = np.flatnonzero(online)
    sel[rs.choice(idx, min(k, idx.size), replace=False)] = True
    return sel


@register_policy("random")
class RandomPolicy(Policy):
    """Vanilla FedAvg: uniform random selection, full distribution."""
    selects_at_most_clients_per_round = True

    def init_state(self) -> np.random.RandomState:
        return np.random.RandomState(self.sim_cfg.seed + 17)

    def plan(self, state, obs):
        N = self.fl_cfg.num_clients
        sel = _random_online(state, to_host(obs.online),
                             self.fl_cfg.clients_per_round, N)
        return state, RoundPlan.create(sel, sel, np.zeros(N, bool),
                                       float(sel.sum()))


@dataclasses.dataclass(frozen=True)
class OortState:
    util: np.ndarray          # (N,) statistical utility (inf = unexplored)
    duration: np.ndarray      # (N,) last observed round duration
    eps: float
    rs: np.random.RandomState


@register_policy("oort")
class OortPolicy(Policy):
    """Oort [OSDI'21], simplified: statistical utility = loss·sqrt(n) with a
    system-speed penalty, ε-greedy exploration.  The ranking reads the
    clients' float losses, so a near-tie can order differently from the
    reference (ROADMAP Queue C)."""
    selects_at_most_clients_per_round = True

    def __init__(self, sim_cfg, fl_cfg, fleet=None, device="cpu"):
        super().__init__(sim_cfg, fl_cfg, fleet, device=device)
        if fleet is None:
            raise ValueError("oort needs the fleet's speed profile")
        self.pref_duration = np.median(
            sim_cfg.local_steps / fleet.steps_per_sec)

    def init_state(self) -> OortState:
        N = self.fl_cfg.num_clients
        return OortState(np.full(N, np.inf), np.ones(N), 0.9,
                         np.random.RandomState(self.sim_cfg.seed + 29))

    def plan(self, state, obs):
        N = self.fl_cfg.num_clients
        online = to_host(obs.online)
        X = min(self.fl_cfg.clients_per_round, int(online.sum()))
        n_explore = int(round(state.eps * X))
        sel = np.zeros(N, bool)
        explored = np.isfinite(state.util)
        pool_new = np.flatnonzero(online & ~explored)
        take_new = min(n_explore, pool_new.size)
        if take_new:
            sel[state.rs.choice(pool_new, take_new, replace=False)] = True
        penal = np.where(state.duration > self.pref_duration,
                         (self.pref_duration / state.duration) ** 0.5, 1.0)
        score = np.where(online & explored & ~sel,
                         np.nan_to_num(state.util, posinf=0.0) * penal,
                         -np.inf)
        rest = X - sel.sum()
        if rest > 0:
            top = np.argsort(-score)[:rest]
            sel[top[score[top] > -np.inf]] = True
        new_state = dataclasses.replace(
            state, eps=max(state.eps * 0.98, 0.2))
        return new_state, RoundPlan.create(sel, sel, np.zeros(N, bool),
                                           float(sel.sum()))

    def observe(self, state, plan, report):
        upd = to_host(plan.selected) & to_host(report.received)
        util = np.where(upd, to_host(report.losses) * np.sqrt(
            self.sim_cfg.batch_size * self.sim_cfg.local_steps), state.util)
        duration = np.where(upd, to_host(report.durations), state.duration)
        return dataclasses.replace(state, util=util, duration=duration)


@register_policy("safa")
class SafaPolicy(Policy):
    """SAFA [IEEE TC'20], simplified semi-async: crashed/straggling devices
    keep local progress (lag-tolerant cache) and are force-synced only when
    their version lag exceeds τ.  Rounds close on SAFA's synchronization
    quota (a fraction of the selected set), not on the last arrival."""
    uses_cache = True
    selects_at_most_clients_per_round = True
    quota = 0.75

    def __init__(self, sim_cfg, fl_cfg, fleet=None, device="cpu",
                 tau: int = 5):
        super().__init__(sim_cfg, fl_cfg, fleet, device=device)
        self.tau = tau

    def init_state(self) -> np.random.RandomState:
        return np.random.RandomState(self.sim_cfg.seed + 43)

    def plan(self, state, obs):
        N = self.fl_cfg.num_clients
        sel = _random_online(state, to_host(obs.online),
                             self.fl_cfg.clients_per_round, N)
        stamp = to_host(obs.caches.round_stamp)
        lag = np.where(stamp >= 0, obs.rnd - stamp, BIG)
        resume = sel & (lag <= self.tau)
        # any selected set needs a quorum of at least one upload, or the
        # round idle-waits the full deadline
        quorum = float(np.floor(sel.sum() * self.quota))
        if sel.any():
            quorum = max(quorum, 1.0)
        return state, RoundPlan.create(sel, sel & ~resume, resume, quorum)


@register_policy("fedsea")
class FedSeaPolicy(Policy):
    """FedSEA [SenSys'22], simplified: balance completion times by scaling
    local steps with device speed; deadline-based aggregation."""
    waits_for_stragglers = False
    selects_at_most_clients_per_round = True

    def __init__(self, sim_cfg, fl_cfg, fleet=None, device="cpu"):
        super().__init__(sim_cfg, fl_cfg, fleet, device=device)
        if fleet is None:
            raise ValueError("fedsea needs the fleet's speed profile")
        rel = fleet.steps_per_sec / fleet.steps_per_sec.max()
        self.steps = np.clip(
            np.round(sim_cfg.local_steps * rel), 1,
            sim_cfg.local_steps).astype(np.int32)

    def init_state(self) -> np.random.RandomState:
        return np.random.RandomState(self.sim_cfg.seed + 57)

    def plan(self, state, obs):
        N = self.fl_cfg.num_clients
        sel = _random_online(state, to_host(obs.online),
                             self.fl_cfg.clients_per_round, N)
        return state, RoundPlan.create(sel, sel, np.zeros(N, bool),
                                       float(sel.sum()),
                                       steps_override=self.steps)


@register_policy("mifa")
class MifaPolicy(Policy):
    """MIFA [NeurIPS'21, arXiv 2106.04159], adapted: memorized-update FL
    under arbitrary device unavailability.  Every online device trains,
    interrupted devices always resume their cached progress, and
    ``agg_weights`` cancels the server's staleness discount
    (``(1+s)^{+d}`` against the engine's ``(1+s)^{-d}``) so memorized
    stale-base updates aggregate undiscounted."""
    uses_cache = True
    waits_for_stragglers = False

    def plan(self, state, obs):
        sel = np.array(to_host(obs.online), bool)
        stamp = to_host(obs.caches.round_stamp)
        resume = sel & (stamp >= 0)
        # undo the engine's staleness discount on resumed (memorized) bases
        stale = np.where(resume, np.maximum(obs.rnd - stamp, 0), 0)
        w = np.power(1.0 + stale,
                     self.fl_cfg.staleness_discount).astype(np.float32)
        return state, RoundPlan.create(sel, sel & ~resume, resume,
                                       float(sel.sum()), agg_weights=w)


@register_policy("asyncfeded")
class AsyncFedEdPolicy(Policy):
    """AsyncFedED [2022], simplified: every online device trains; arrivals
    are aggregated with staleness-adaptive weights (euclidean-distance
    surrogate = version lag)."""
    waits_for_stragglers = False

    def init_state(self) -> np.ndarray:
        return np.zeros(self.fl_cfg.num_clients, np.int32)   # last sync rnd

    def plan(self, state, obs):
        sel = np.array(to_host(obs.online), bool)
        lag = obs.rnd - state
        w = 1.0 / (1.0 + np.maximum(lag, 0))
        return state, RoundPlan.create(sel, sel, np.zeros_like(sel),
                                       float(sel.sum()), agg_weights=w)

    def observe(self, state, plan, report):
        return np.where(to_host(report.received), report.rnd, state)
