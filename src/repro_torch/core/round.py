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
13–16) the host loop runs, ``make_round_cut`` its float32 device form for
the device dynamics loop.

The server step and the device cut each have a compact-cohort variant
(``cohort_size=`` / ``scatter_num_clients=``) over the round's (X,)
selected rows, and the server step a host-offload variant
(``cache_offload=``) whose caches carry metadata only.
"""
from __future__ import annotations

import math
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
    """Fresh fleet state on ``device``, filled there (nothing is copied
    from the host, so a run's set-up does not wait for the card)."""
    N = cfg.num_clients

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=device)
    return FludeState(
        belief=init_belief(N, cfg.beta_alpha0, cfg.beta_beta0, device),
        part_count=torch.zeros((N,), dtype=torch.int32, device=device),
        explored=torch.zeros((N,), dtype=torch.bool, device=device),
        in_v=torch.zeros((N,), dtype=torch.bool, device=device),
        distributor=D.init_distributor(cfg.w_init, device),
        epsilon=f32(cfg.epsilon_init),
        total_selected=f32(0.0),
        round=torch.zeros((), dtype=torch.int32, device=device),
    )


def _plan_once(state: FludeState, caches: C.ClientCaches,
               online: torch.Tensor, X, cfg: FLConfig, uniforms,
               explore_hints=None, thompson_draws=None) -> FludePlan:
    sel = SEL.select_participants(
        state.belief, state.part_count, state.explored, online,
        state.total_selected, X, state.epsilon, cfg.sigma, uniforms,
        explore_hints=explore_hints, thompson_draws=thompson_draws)
    stale = C.staleness(caches, state.round)
    plan = D.plan_distribution(
        state.distributor, sel.selected, state.in_v, C.has_cache(caches),
        stale, lam=cfg.lam, mu=cfg.mu, w_min=cfg.w_min, w_max=cfg.w_max,
        mode=cfg.distribution_mode)
    r_sel = torch.where(sel.selected, dependability(state.belief), 0.0)
    n_sel = sel.selected.sum().clamp_min(1)
    # exact sum, rounded once: the floor below must not depend on the
    # device's summation order (the card and the CPU agree bit for bit).
    # In int64 units of 2^-40, where every R(i) >= 2^-17 is a whole
    # number and integer sums are exact in any order, so the round path
    # holds no float64 (a smaller R(i) drops its bits below 2^-40)
    units = (r_sel * 2.0 ** 40).to(torch.int64).sum()
    r_bar = units.to(torch.float32) * 2.0 ** -40 / n_sel
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
               explore_hints=None, thompson_draws=None) -> FludePlan:
    """Algorithm 2 lines 3–11: shrink X until B_pred ≤ B_max.

    ``uniforms``: the round's (N,) explore noise in [0, 1);
    ``thompson_draws``: under ``cfg.selection_mode="thompson"`` the
    round's (N,) Beta sample of the beliefs.  Every budget iteration
    reuses both, as the reference reuses the round's key.
    ``explore_hints``: optional (N,) device-status scores (battery ×
    stability) biasing exploration order — §4.1's optional heuristic."""
    if (cfg.selection_mode == "thompson") != (thompson_draws is not None):
        raise ValueError(
            f"plan_round: selection_mode={cfg.selection_mode!r} takes "
            f"thompson_draws exactly under 'thompson'")
    X = torch.clamp_max(online.sum(), cfg.clients_per_round)
    plan = _plan_once(state, caches, online, X, cfg, uniforms,
                      explore_hints, thompson_draws)
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
                          explore_hints, thompson_draws)
    return plan


def make_server_round_step(template_params, *, local_steps: int,
                           agg_impl: str = "cuda",
                           agg_rule: str = "mean",
                           agg_rule_params: tuple = (),
                           adversary_scale: Optional[float] = None,
                           staleness_discount: float = 1.0,
                           uses_cache: bool = True,
                           block_c: int = 8, block_d: int = 2048,
                           cohort_size: Optional[int] = None,
                           cache_offload: Optional[str] = None):
    """Build the per-round server step: the full scan, or with
    ``cohort_size`` its compact-cohort variant.

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

    ``cohort_size`` (X): the trainer outputs, ``fail`` and ``received``
    are (X,)-leading cohort blocks and the step takes the (X,) cohort
    index ``idx`` after ``cached_steps``; the (N,) plan masks, caches,
    sample counts, weight multipliers, malicious mask and rule state are
    gathered at ``idx`` inside, and the caches and the rule state
    scattered back in place (their (N,) tensors must be ``spare_rows``
    views).  ``cache_offload`` (needs ``cohort_size``): the caches carry
    metadata only (an empty params dict), ``cache_params`` is not an
    argument (the engine streams the trainer's cache block to the host
    store itself), and the step returns ``(new_global, new_caches, write,
    base_round[, rule_state])``: the (X,) write mask and round stamps the
    write-back needs.  Both variants run the same weight, aggregation and
    metadata ops, so offload rows equal resident rows bit for bit.
    """
    if cache_offload is not None and cohort_size is None:
        raise ValueError("cache_offload requires the cohort server-step "
                         "variant (pass cohort_size)")
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

    def cohort_step(global_params, caches, final_params, cache_params,
                    cached_steps, idx, selected, fail, received, resume,
                    n_samples, extra_weights, rnd, extra):
        """The shared body of both cohort variants; ``cache_params`` is
        None under offload.  Returns ``(new_global, caches, write,
        base_round, rule_state)``."""
        malicious, rule_state = split_extra(extra)
        rnd = torch.full((), rnd, dtype=torch.int32, device=idx.device)

        def take(a, fill):
            return C.take_rows(a, idx, fill)

        selected = take(selected, False)              # (X,)
        resume = take(resume, False)
        stamp = take(caches.round_stamp, -1)          # (X,)
        base_stale = torch.where(resume & (stamp >= 0),
                                 (rnd - stamp).clamp_min(0),
                                 0).to(torch.float32)
        w = AGG.aggregation_weights(
            received, n_samples=take(n_samples, 0.0), staleness=base_stale,
            staleness_discount=staleness_discount) \
            * take(extra_weights, 0.0)
        if has_adv:
            final_params = poison(final_params, global_params,
                                  take(malicious, False))
        state_x = take(rule_state, 0.0) if stateful else None
        new_global, state_x = aggregate(global_params, final_params, w,
                                        state_x)
        if stateful:
            C.scatter_rows(rule_state, idx, state_x)
        write = base_round = None
        if uses_cache:
            prior_steps = torch.round(take(caches.progress, 0.0)
                                      * local_steps).to(torch.int32)
            total_cached = torch.where(resume, prior_steps, 0) \
                + cached_steps
            write = selected & fail & (total_cached > 0)
            base_round = torch.where(resume & (stamp >= 0), stamp, rnd)
            # under offload the params dict is empty: the same writes
            # touch only progress and round_stamp
            caches = C.scatter_write_cache(
                caches, idx, write,
                caches.params if cache_params is None else cache_params,
                (total_cached / max(local_steps, 1)).to(torch.float32),
                base_round)
            caches = C.scatter_clear_cache(caches, idx, received)
        return new_global, caches, write, base_round, rule_state

    if cohort_size is not None and cache_offload is not None:
        def server_round_step_cohort_offload(
                global_params, caches: C.ClientCaches, final_params,
                cached_steps, idx, selected, fail, received, resume,
                n_samples, extra_weights, rnd, *extra):
            """-> (new_global, new_caches, write, base_round
            [, new_rule_state]).  ``caches`` is metadata only; ``write``
            and ``base_round`` are the (X,) cache-write mask and round
            stamps the engine stages to the host store."""
            new_global, caches, write, base_round, rule_state = \
                cohort_step(global_params, caches, final_params, None,
                            cached_steps, idx, selected, fail, received,
                            resume, n_samples, extra_weights, rnd, extra)
            if write is None:
                write = torch.zeros((cohort_size,), dtype=torch.bool,
                                    device=idx.device)
                base_round = torch.full((cohort_size,), -1,
                                        dtype=torch.int32,
                                        device=idx.device)
            if stateful:
                return new_global, caches, write, base_round, rule_state
            return new_global, caches, write, base_round

        return server_round_step_cohort_offload

    if cohort_size is not None:
        def server_round_step_cohort(global_params, caches: C.ClientCaches,
                                     final_params, cache_params,
                                     cached_steps, idx, selected, fail,
                                     received, resume, n_samples,
                                     extra_weights, rnd, *extra):
            """-> (new_global_params, new_caches[, new_rule_state]).

            final_params / cache_params / cached_steps and ``fail`` /
            ``received`` are (X,)-leading cohort blocks; ``idx`` is the
            (X,) cohort index (sentinel-padded); ``selected`` / ``resume``
            are the (N,) plan masks, gathered here."""
            new_global, caches, _, _, rule_state = cohort_step(
                global_params, caches, final_params, cache_params,
                cached_steps, idx, selected, fail, received, resume,
                n_samples, extra_weights, rnd, extra)
            if stateful:
                return new_global, caches, rule_state
            return new_global, caches

        return server_round_step_cohort

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
        # filled on the device: a host copy would wait for the card
        rnd = torch.full((), rnd, dtype=torch.int32, device=stamp.device)
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


def make_round_cut(num_clients: int, round_deadline: float,
                   waits_for_stragglers: bool,
                   scatter_num_clients: Optional[int] = None):
    """Build the device round cut (Algorithm 2 lines 13–16).

    Semantically :func:`host_round_cut`, in float32 on the engine's
    device, as the reference's ``make_round_cut(..., with_counts=True)``.
    The returned callable maps ``(times, quorum, success, online,
    distribute, selected)`` to ``(t_cut, received, capped,
    received_count, download_count, selected_count)``:

    * ``t_cut`` — 0-d float32 tensor; the billed duration is
      ``round_deadline if capped else float(t_cut)``: a deadline such as
      100.3 has no float32 value, so the cap comes back as a flag and the
      ledger bills the exact configured deadline;
    * ``received`` — the (N,) receive mask.  A capped round compares
      against the float32-nearest cast of the deadline (``d_cmp``);
    * ``capped`` — 0-d bool: the round closed at the deadline rather than
      at an arrival, decided against the largest float32 ≤ the deadline
      (``d_flag``), so the flag is exact;
    * the round's three History counts as 0-d tensors, the downloads
      being ``distribute & online``.

    ``quorum`` is a 0-d tensor (a policy that plans on the device) or a
    python number.  Nothing is read back to the host: the order statistic
    is taken with ``index_select`` on a device index.

    ``scatter_num_clients`` (N): the compact-cohort variant.
    ``num_clients`` is then the cohort size X, ``times`` / ``success``
    are (X,) blocks, the callable takes the (X,) cohort index after
    ``success`` and returns ``(t_cut, received, received_full, capped,
    counts...)`` with ``received_full`` the (N,) receive mask.  Every
    finite time belongs to a selected client and selected ⊆ cohort, so
    the cut over the X rows equals the cut over all N; the received
    count of the (X,) block is the fleet's (sentinel rows never
    receive).
    """
    deadline = float(round_deadline)
    # nearest float32: what a capped round's uploads are compared against
    d_cmp = np.float32(deadline)
    # largest float32 <= deadline: for float32 t, (t > d_flag) == (t > d)
    d_flag = d_cmp
    if float(d_flag) > deadline:
        d_flag = np.nextafter(d_flag, np.float32(-np.inf))
    d_cmp, d_flag = float(d_cmp), float(d_flag)
    last = num_clients - 1

    def at(order, i):
        """order[i] for a 0-d device index, without a read-back."""
        return torch.index_select(order, 0,
                                  i.clamp(0, last).reshape(1).long())[0]

    def cut_core(times, quorum, success):
        if isinstance(quorum, torch.Tensor):
            q = torch.ceil(quorum.to(torch.float32)).to(torch.int32)
        else:
            q = torch.full((), math.ceil(np.float32(quorum)),
                           dtype=torch.int32, device=times.device)
        order = torch.sort(times).values          # inf sorts to the end
        finite_count = torch.isfinite(times).sum()
        has_quorum = (finite_count >= q) & (q > 0)
        t_raw = torch.where(has_quorum, at(order, q - 1), math.inf)
        if not waits_for_stragglers:
            # async/semi-async designs close at the last arrival
            t_raw = torch.where(~has_quorum & (finite_count > 0),
                                at(order, finite_count - 1), t_raw)
        capped = t_raw > d_flag
        t_cut = torch.where(capped, d_cmp, t_raw)
        received = success & (times <= t_cut)
        return t_cut, received, capped

    def round_cut(times, quorum, success, online, distribute, selected):
        t_cut, received, capped = cut_core(times, quorum, success)
        return (t_cut, received, capped, received.sum(),
                (distribute & online).sum(), selected.sum())

    if scatter_num_clients is None:
        return round_cut
    n = int(scatter_num_clients)

    def round_cut_cohort(times, quorum, success, idx, online, distribute,
                         selected):
        t_cut, received, capped = cut_core(times, quorum, success)
        received_full = C.scatter_rows(
            C.spare_rows(n, (), False, torch.bool, idx.device), idx,
            received)
        return (t_cut, received, received_full, capped, received.sum(),
                (distribute & online).sum(), selected.sum())

    return round_cut_cohort


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
