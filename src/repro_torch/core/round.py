"""C5 — the FLUDE round process (paper §4.4, Algorithm 2), server side.

``plan_round`` runs lines 3–12: budget-adaptive participant count X,
Algorithm-1 selection, staleness-aware distribution, predicted comm cost.
``update_after_round`` runs the post-aggregation bookkeeping: Beta-posterior
updates (Eq. 1), participation counters (Eq. 3 numerator), U/V membership,
ε decay.  Both are tensor code over fixed-shape fleet state on the engine's
device.

``make_server_round_step`` builds the per-round server step: weight
computation (incl. staleness discount), the model-poisoning transform of
an adversary, packed aggregation under the configured rule, and cache
write/clear.  ``host_round_cut`` is the numpy round termination (lines
13–16) the host loop runs.

The port runs the full-scan server step; the cohort and offload variants
belong to ROADMAP Queue A #10 and #12.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import aggregation as AGG
from repro_torch.core import caching as C
from repro_torch.core import distribution as D
from repro_torch.core import selection as SEL
from repro_torch.core.agg_rules import make_agg_rule
from repro_torch.core.dependability import (BetaBelief, dependability,
                                            init_belief, update_belief)
from repro_torch.tree import tree_map


class FludeState(NamedTuple):
    """Full server-side fleet state."""
    belief: BetaBelief
    part_count: torch.Tensor       # (N,) int32 — q_i
    explored: torch.Tensor         # (N,) bool — C
    in_v: torch.Tensor             # (N,) bool — failed last participation
    distributor: D.DistributorState
    epsilon: torch.Tensor          # 0-d float32
    total_selected: torch.Tensor   # 0-d float32 — Σ_k |S_k|
    round: torch.Tensor            # 0-d int32


class FludePlan(NamedTuple):
    selected: torch.Tensor         # (N,) bool — S
    distribute: torch.Tensor       # (N,) bool — S_distr (fresh global model)
    resume: torch.Tensor           # (N,) bool — train from local cache
    predicted_cost: torch.Tensor   # 0-d — B_pred (model transmissions)
    quorum: torch.Tensor           # 0-d — |S| · R̄ receive cutoff
    avg_dependability: torch.Tensor
    priority: torch.Tensor         # (N,) — P(i), for logging
    distributor: D.DistributorState


def init_state(cfg: FLConfig, device="cpu") -> FludeState:
    N = cfg.num_clients

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return FludeState(
        belief=init_belief(N, cfg.beta_alpha0, cfg.beta_beta0, device),
        part_count=torch.zeros((N,), dtype=torch.int32, device=device),
        explored=torch.zeros((N,), dtype=torch.bool, device=device),
        in_v=torch.zeros((N,), dtype=torch.bool, device=device),
        distributor=D.init_distributor(cfg.w_init, device),
        epsilon=f32(cfg.epsilon_init),
        total_selected=f32(0.0),
        round=torch.tensor(0, dtype=torch.int32, device=device),
    )


def _plan_once(state: FludeState, caches: C.ClientCaches,
               online: torch.Tensor, X, cfg: FLConfig, uniforms,
               explore_hints=None) -> FludePlan:
    sel = SEL.select_participants(
        state.belief, state.part_count, state.explored, online,
        state.total_selected, X, state.epsilon, cfg.sigma, uniforms,
        explore_hints=explore_hints)
    stale = C.staleness(caches, state.round)
    plan = D.plan_distribution(
        state.distributor, sel.selected, state.in_v, C.has_cache(caches),
        stale, lam=cfg.lam, mu=cfg.mu, w_min=cfg.w_min, w_max=cfg.w_max,
        mode=cfg.distribution_mode)
    r_sel = torch.where(sel.selected, dependability(state.belief), 0.0)
    n_sel = sel.selected.sum().clamp_min(1)
    # exact sum, rounded once: the floor below must not depend on the
    # device's summation order (the card and the CPU agree bit for bit)
    r_bar = r_sel.sum(dtype=torch.float64).to(torch.float32) / n_sel
    cost = D.predicted_comm_cost(plan.distribute, sel.selected, r_bar)
    # floor: with quorum = ceil(|S|·R̄), ~half the rounds have fewer
    # successes than the quorum and idle-wait the full deadline T —
    # exactly the waste Algorithm 2 is designed to avoid
    quorum = torch.floor(sel.selected.sum() * r_bar).clamp_min(1.0)
    return FludePlan(sel.selected, plan.distribute, plan.resume, cost,
                     quorum, r_bar, sel.priority, plan.state)


def plan_round(state: FludeState, caches: C.ClientCaches,
               online: torch.Tensor, cfg: FLConfig, uniforms,
               max_budget_iters: int = 8,
               explore_hints=None) -> FludePlan:
    """Algorithm 2 lines 3–11: shrink X until B_pred ≤ B_max.

    ``uniforms``: the round's (N,) explore noise in [0, 1); every budget
    iteration reuses it, as the reference reuses the round's key.
    ``explore_hints``: optional (N,) device-status scores (battery ×
    stability) biasing exploration order — §4.1's optional heuristic."""
    X = torch.clamp_max(online.sum(), cfg.clients_per_round)
    plan = _plan_once(state, caches, online, X, cfg, uniforms,
                      explore_hints)
    if cfg.comm_budget == float("inf"):
        return plan
    b_max = cfg.comm_budget
    for _ in range(max_budget_iters):
        X = torch.where(
            plan.predicted_cost > b_max,
            (X * b_max / plan.predicted_cost.clamp_min(1e-9)
             ).to(torch.int32).clamp_min(1),
            X)
        plan = _plan_once(state, caches, online, X, cfg, uniforms,
                          explore_hints)
    return plan


def make_server_round_step(template_params, *, local_steps: int,
                           agg_impl: str = "cuda",
                           agg_rule: str = "mean",
                           agg_rule_params: tuple = (),
                           adversary_scale: Optional[float] = None,
                           staleness_discount: float = 1.0,
                           uses_cache: bool = True,
                           block_c: int = 8, block_d: int = 2048):
    """Build the per-round server step (full scan).

    The returned callable runs everything the server does between "uploads
    arrived" and "next round plans": aggregation weights (sample-count ×
    staleness discount for resumed bases, §4.3), the packed whole-model
    aggregation and C3 cache bookkeeping (write failed devices' progress,
    clear received slots).  Nothing in it reads a value back to the host.

    template_params: the *unstacked* global model — fixes the packed
    (C, D) layout once.  ``uses_cache=False`` policies skip the cache
    bookkeeping.

    ``agg_rule`` / ``agg_rule_params``: the robust-aggregation axis
    (``repro_torch.core.agg_rules``).  The default ``"mean"`` keeps the
    direct ``fed_aggregate_packed`` call — one ``fed_agg`` call, one
    kernel launch on the card.  Other rules pack the trainer outputs
    once and reduce the (C, D) buffer; a *stateful* rule ("trust") takes
    one (N,) state input and returns it updated as a third output.

    ``adversary_scale``: when set, the step also takes an (N,) malicious
    mask and transforms the marked clients' uploads as
    ``u' = g + adversary_scale * (u - g)`` — the model-poisoning channel
    of ``repro_torch.fleet.adversary``.  Trailing arguments after ``rnd``
    come in the order: malicious mask, then rule state.
    """
    layout = AGG.pack_layout(template_params)
    rule = None if agg_rule in (None, "mean") else \
        make_agg_rule(agg_rule, agg_rule_params)
    stateful = rule is not None and rule.stateful
    has_adv = adversary_scale is not None

    def poison(final_params, global_params, mal_rows):
        """Model-poisoning transform on the malicious rows (stacked
        leaves), against the round's base model; cast back to each
        leaf's dtype."""
        s = float(adversary_scale)

        def pz(f, g):
            m = mal_rows.reshape((-1,) + (1,) * (f.ndim - 1))
            g32 = g.to(torch.float32)[None]
            return torch.where(m, (g32 + s * (f.to(torch.float32) - g32))
                               .to(f.dtype), f)

        return tree_map(pz, final_params, global_params)

    def aggregate(global_params, final_params, w, rule_state):
        """Dispatch the configured rule.  Returns ``(new_global,
        new_rule_state)`` — state rows pass through untouched for
        stateless rules."""
        if rule is None:
            new_global = AGG.fed_aggregate_packed(
                global_params, final_params, w, layout, impl=agg_impl,
                block_c=block_c, block_d=block_d)
            return new_global, rule_state
        buf = AGG.pack_stacked(final_params, layout)     # (C, D) fp32
        gvec = AGG.pack(global_params, layout)           # (D,) fp32
        kw = dict(impl=agg_impl, block_c=block_c, block_d=block_d)
        if stateful:
            vec, rule_state = rule.reduce_stateful(buf, gvec, w,
                                                   rule_state, **kw)
        else:
            vec = rule.reduce(buf, gvec, w, **kw)
        any_received = w.sum() > 0
        new_global = tree_map(
            lambda avg, g: torch.where(any_received, avg, g),
            AGG.unpack(vec, layout), global_params)
        return new_global, rule_state

    def split_extra(extra):
        """(malicious, rule_state) from the trailing arguments."""
        expect = int(has_adv) + int(stateful)
        if len(extra) != expect:
            raise TypeError(
                f"server round step expects {expect} trailing arg(s) "
                f"(adversary mask: {has_adv}, rule state: {stateful}), "
                f"got {len(extra)}")
        malicious = extra[0] if has_adv else None
        rule_state = extra[-1] if stateful else None
        return malicious, rule_state

    def server_round_step(global_params, caches: C.ClientCaches,
                          final_params, cache_params, cached_steps,
                          selected, fail, received, resume,
                          n_samples, extra_weights, rnd, *extra):
        """-> (new_global_params, new_caches[, new_rule_state]).

        final_params / cache_params: stacked (N, ...) trainer outputs.
        selected/fail/received/resume: (N,) bool round masks.
        extra_weights: (N,) policy weight multiplier (ones if unused).
        rnd: int — current round index.
        extra: the (N,) malicious mask (adversary configured) then the
        (N,) rule state (stateful rule).
        """
        malicious, rule_state = split_extra(extra)
        stamp = caches.round_stamp
        rnd = torch.tensor(rnd, dtype=torch.int32, device=stamp.device)
        # staleness of the BASE model each update was trained from
        base_stale = torch.where(resume & (stamp >= 0),
                                 (rnd - stamp).clamp_min(0),
                                 0).to(torch.float32)
        w = AGG.aggregation_weights(
            received, n_samples=n_samples, staleness=base_stale,
            staleness_discount=staleness_discount) * extra_weights
        if has_adv:
            final_params = poison(final_params, global_params, malicious)
        new_global, rule_state = aggregate(global_params, final_params,
                                           w, rule_state)
        if uses_cache:
            prior_steps = torch.round(caches.progress * local_steps
                                      ).to(torch.int32)
            total_cached = torch.where(resume, prior_steps, 0) \
                + cached_steps
            write = selected & fail & (total_cached > 0)
            base_round = torch.where(resume & (stamp >= 0), stamp, rnd)
            caches = C.write_cache(
                caches, write, cache_params,
                (total_cached / max(local_steps, 1)).to(torch.float32),
                base_round)
            caches = C.clear_cache(caches, received)
        if stateful:
            return new_global, caches, rule_state
        return new_global, caches

    return server_round_step


def host_round_cut(times, quorum, round_deadline: float,
                   waits_for_stragglers: bool):
    """Round termination (Algorithm 2 lines 13–16), numpy.

    ``times``: (N,) per-device finish times, inf where the device never
    uploads.  The round closes at the ``ceil(quorum)``-th upload (capped
    by the deadline T); async/semi-async designs
    (``waits_for_stragglers=False``) close at the last arrival when the
    quorum is not met; otherwise the server idle-waits the full deadline.
    Returns ``(t_cut, duration)`` — ``duration`` is the billed round wall
    clock (always finite when the deadline is).
    """
    times = np.asarray(times)
    q = int(np.ceil(float(quorum)))
    finite = np.sort(times[np.isfinite(times)])
    if finite.size >= q and q > 0:
        t_cut = min(float(finite[q - 1]), round_deadline)
    elif not waits_for_stragglers and finite.size > 0:
        t_cut = min(float(finite[-1]), round_deadline)
    else:
        t_cut = round_deadline
    duration = t_cut if np.isfinite(t_cut) else round_deadline
    return t_cut, duration


def update_after_round(state: FludeState, plan: FludePlan,
                       received: torch.Tensor, cfg: FLConfig) -> FludeState:
    """Post-round bookkeeping.  received: (N,) bool — uploaded in time."""
    sel = plan.selected
    success = sel & received
    failure = sel & ~received
    return FludeState(
        belief=update_belief(state.belief, success, failure),
        part_count=state.part_count + sel.to(torch.int32),
        explored=state.explored | sel,
        in_v=torch.where(sel, failure, state.in_v),
        distributor=plan.distributor,
        epsilon=SEL.decay_epsilon(state.epsilon, cfg.epsilon_decay,
                                  cfg.epsilon_min),
        total_selected=state.total_selected + sel.sum().to(torch.float32),
        round=state.round + 1,
    )
