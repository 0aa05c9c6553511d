"""FleetEngine: the FL round loop behind the typed policy API.

The port of ``repro.fl.engine`` on the host-RNG round loop
(``dynamics="bernoulli_host"``), full scan, one device.  The engine owns
the all-fleet local trainer, the per-round server step (weights, the
adversary's poison, packed aggregation under the configured rule through
the hand-written ``fed_agg`` and ``residual_norms`` kernels, C3 cache
bookkeeping) and the fleet simulator; policies are ``plan``/``observe``
transitions over ``RoundPlan``/``RoundReport``.

Global params and client caches stay on the engine's device across rounds;
the host sees (N,)-sized masks each round and the test accuracy at
``eval_every`` boundaries.  The engine runs on the CUDA card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import caching as C
from repro_torch.core import round as R
from repro_torch.core.agg_rules import make_agg_rule
from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import FederatedClassification
from repro_torch.device import resolve_device
from repro_torch.fl import classifier as CLF
from repro_torch.fl import policies as _builtin_policies  # noqa: F401
from repro_torch.fl.api import (Policy, RoundObservation, RoundReport,
                                make_policy, to_host)
from repro_torch.fl.simulator import Fleet, SimConfig
from repro_torch.fleet.adversary import make_adversary
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BIG = 1 << 20


# ---------------------------------------------------------------------------
# Vectorized local trainer
# ---------------------------------------------------------------------------

def make_trainer(sim_cfg: SimConfig, data: FederatedClassification,
                 device="cpu"):
    """Build the all-fleet local trainer over the client training set,
    placed once on ``device``.

    Plain PyTorch, no kernel of its own (the reference leaves it to XLA):
    the stacked per-client models run through ``torch.bmm``, and one
    ``torch.autograd.grad`` of the sum of the per-client mean losses gives
    every client exactly its own gradient — the clients' parameters are
    independent, so the sum's gradient with respect to client i's
    parameters is the gradient of client i's loss.
    """
    device = torch.device(device)
    x_all = torch.as_tensor(data.x, dtype=torch.float32, device=device)
    y_all = torch.as_tensor(data.y, device=device).long()
    n = x_all.shape[1]
    b = min(sim_cfg.batch_size, n)
    lr = sim_cfg.lr
    max_steps = sim_cfg.local_steps
    arange_b = torch.arange(b, device=device)

    def local_scan(x_arr, y_arr, start_params, steps_needed, stop_step,
                   cache_every):
        """The masked local-training loop over the client axis of
        ``x_arr``/``y_arr``; a Python loop stands in for ``lax.scan``."""
        params = start_params
        cache = start_params
        rows = x_arr.shape[0]
        cached_steps = torch.zeros((rows,), dtype=torch.int32,
                                   device=x_arr.device)
        loss_sum = torch.zeros((rows,), dtype=torch.float32,
                               device=x_arr.device)
        every = cache_every.clamp_min(1)
        for j in range(max_steps):
            idx = (j * b + arange_b) % n
            xb = x_arr[:, idx]
            yb = y_arr[:, idx]
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            with torch.enable_grad():
                loss = CLF.clf_loss(tree_unflatten(params, leaves), xb, yb)
                grads = torch.autograd.grad(loss.sum(), leaves)
            grads = tree_unflatten(params, grads)
            loss = loss.detach()
            # the loss is taken before the update, as in the reference
            active = (j < steps_needed) & (j < stop_step)

            def upd(p, g):
                m = active.reshape((-1,) + (1,) * (p.ndim - 1))
                return torch.where(m, p - lr * g, p)

            params = tree_map(upd, params, grads)
            do_cache = active & ((j + 1) % every == 0)

            def cupd(c, p):
                m = do_cache.reshape((-1,) + (1,) * (p.ndim - 1))
                return torch.where(m, p, c)

            cache = tree_map(cupd, cache, params)
            cached_steps = torch.where(do_cache, j + 1, cached_steps)
            loss_sum = loss_sum + torch.where(active, loss, 0.0)
        # normalize by the steps that actually *ran*: the loop is
        # max_steps long, so a larger request trains max_steps at most
        done = torch.minimum(steps_needed, stop_step).clamp_max(max_steps)
        mean_loss = loss_sum / done.clamp_min(1)
        return params, cache, cached_steps, mean_loss

    def train_all(global_params, caches, resume, steps_needed, stop_step,
                  cache_every):
        """All-fleet masked local training (incl. resume selection).

        global_params: unstacked global model; each client starts from
                       it unless ``resume`` picks its cached state.
        caches:       core.ClientCaches (stacked (N, ...) params).
        resume:       (N,) bool — train from local cache (C3/C4).
        steps_needed: (N,) steps each device must run (0 = idle).
        stop_step:    (N,) interruption step (>= steps_needed: no
                      failure).
        cache_every:  (N,) cache interval in steps (C3 adaptive).
        Returns (final_params, cache_params, cached_steps, mean_loss).
        """
        start_params = C.resume_params(caches, global_params, resume)
        return local_scan(x_all, y_all, start_params, steps_needed,
                          stop_step, cache_every)

    return train_all


# ---------------------------------------------------------------------------
# Round history
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class History:
    acc: List[float] = dataclasses.field(default_factory=list)
    comm_mb: List[float] = dataclasses.field(default_factory=list)   # cum.
    wall_clock: List[float] = dataclasses.field(default_factory=list)
    received: List[int] = dataclasses.field(default_factory=list)
    selected: List[int] = dataclasses.field(default_factory=list)
    # eval_mask[t] is False when acc[t] is a carried-forward stale value
    # (eval_every > 1 skipped the measurement that round)
    eval_mask: List[bool] = dataclasses.field(default_factory=list)
    part_count: Optional[np.ndarray] = None
    per_class_acc: Optional[np.ndarray] = None
    per_client_acc: Optional[np.ndarray] = None
    final_params: Any = None
    # final per-client trust scores (stateful robust rules)
    trust: Optional[np.ndarray] = None

    _ARRAY_EXTRAS = ("part_count", "per_class_acc", "per_client_acc",
                     "trust")

    def to_json(self) -> dict:
        """JSON-serializable trajectory dict (the golden-file format);
        ``final_params`` is deliberately excluded."""
        d = {"acc": [float(a) for a in self.acc],
             "comm_mb": [float(c) for c in self.comm_mb],
             "wall_clock": [float(t) for t in self.wall_clock],
             "received": [int(r) for r in self.received],
             "selected": [int(s) for s in self.selected],
             "eval_mask": [bool(m) for m in self.eval_mask]}
        for name in self._ARRAY_EXTRAS:
            v = getattr(self, name, None)
            if v is not None:
                d[name] = np.asarray(v).tolist()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "History":
        """Inverse of ``to_json``; tolerates golden dicts without
        ``eval_mask`` (the empty mask reads as all-True)."""
        h = cls(acc=[float(a) for a in d.get("acc", ())],
                comm_mb=[float(c) for c in d.get("comm_mb", ())],
                wall_clock=[float(t) for t in d.get("wall_clock", ())],
                received=[int(r) for r in d.get("received", ())],
                selected=[int(s) for s in d.get("selected", ())],
                eval_mask=[bool(m) for m in d.get("eval_mask", ())])
        for name in cls._ARRAY_EXTRAS:
            if d.get(name) is not None:
                setattr(h, name, np.asarray(d[name]))
        return h

    def _evaluated(self):
        mask = self.eval_mask or [True] * len(self.acc)
        for t, c, a, m in zip(self.wall_clock, self.comm_mb, self.acc,
                              mask):
            if m:
                yield t, c, a

    def time_to_accuracy(self, target: float) -> float:
        for t, _, a in self._evaluated():
            if a >= target:
                return t
        return float("inf")

    def comm_to_accuracy(self, target: float) -> float:
        for _, c, a in self._evaluated():
            if a >= target:
                return c
        return float("inf")


# ---------------------------------------------------------------------------
# FleetEngine
# ---------------------------------------------------------------------------

class FleetEngine:
    """Owns trainer + server step + fleet; runs policies by name.

        engine = FleetEngine(data, sim_cfg, fl_cfg)        # on the card
        hist = engine.run("flude")                         # sim_cfg.rounds

    A fleet passed to the constructor is reused (and its RNG advances
    across runs); otherwise each run draws a fresh ``Fleet(sim_cfg)`` so
    fixed seeds reproduce.

    ``template``: the initial global model as a nested dict of tensors
    (``repro_torch.convert.params_from_jax`` makes one from the
    reference's parameters — a test hook).  Without one the engine draws
    the classifier from a ``torch.Generator`` seeded with
    ``sim_cfg.seed + 1``: the reference's law, not its numbers.
    """

    def __init__(self, data: FederatedClassification, sim_cfg: SimConfig,
                 fl_cfg: FLConfig, fleet: Optional[Fleet] = None,
                 template=None, device=None):
        self.device = resolve_device(device)
        # the reference computes in full fp32: no TF32 in matmuls or
        # convolutions on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # adversarial fleet (repro_torch.fleet.adversary): the malicious
        # mask is drawn once (deterministic in the sim seed), label
        # poisoning rewrites the training set before the trainer sees it
        # (the test set stays clean), and model poisoning runs inside the
        # server step via ``adversary_scale``
        self._adv_scale = None
        self._malicious = None
        if fl_cfg.adversary is not None:
            adversary = make_adversary(fl_cfg.adversary,
                                       fl_cfg.adversary_params)
            mal = adversary.malicious_mask(fl_cfg.num_clients, sim_cfg.seed)
            self._adv_scale = adversary.delta_scale
            if adversary.flips_labels:
                data = adversary.corrupt_data(data, mal)
            if self._adv_scale is not None:
                # per-run invariant: placed on the device once
                self._malicious = torch.from_numpy(mal).to(self.device)
        self._agg_rule = None if fl_cfg.agg_rule == "mean" else \
            make_agg_rule(fl_cfg.agg_rule, fl_cfg.agg_rule_params)
        self._agg_stateful = self._agg_rule is not None \
            and self._agg_rule.stateful
        self.data = data
        self.sim_cfg = sim_cfg
        self.fl_cfg = fl_cfg
        self._fleet = fleet
        self._trainer = None      # built on first run
        self._server_steps = {}
        self._last_caches = None  # previous run's fleet caches (recycled)
        if template is None:
            gen = torch.Generator().manual_seed(sim_cfg.seed + 1)
            template = CLF.init_classifier(
                gen, self.device, dim=data.x.shape[-1],
                num_classes=data.num_classes, hidden=sim_cfg.model_hidden,
                depth=sim_cfg.model_depth)
        else:
            template = tree_map(lambda a: torch.as_tensor(a).to(self.device),
                                template)
        self._template = template
        self._test_x = torch.as_tensor(data.test_x, dtype=torch.float32,
                                       device=self.device)
        self._test_y = torch.as_tensor(data.test_y,
                                       device=self.device).long()
        self._n_samples = torch.full((fl_cfg.num_clients,),
                                     float(data.x.shape[1]),
                                     dtype=torch.float32, device=self.device)

    @property
    def trainer(self):
        """The all-fleet trainer, built on first use (it places the
        client training set on the device)."""
        if self._trainer is None:
            self._trainer = make_trainer(self.sim_cfg, self.data,
                                         self.device)
        return self._trainer

    def _put(self, arr) -> torch.Tensor:
        """Place one host (N,) per-client array on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _accuracy(self, params) -> float:
        return float(CLF.clf_accuracy(params, self._test_x, self._test_y))

    def _fresh_caches(self, template):
        """Empty (N, ...) C3 cache state for a new run.  The previous
        run's caches are reset in place: nothing outside the engine holds
        them, and the fill reuses their O(N·D) buffers."""
        spent, self._last_caches = self._last_caches, None
        if spent is not None:
            return C.reset_caches(spent)
        return C.init_caches(template, self.fl_cfg.num_clients)

    def _server_step(self, uses_cache: bool):
        # keyed by everything that changes the step
        fl = self.fl_cfg
        key = (bool(uses_cache), fl.agg_impl, fl.agg_rule,
               fl.agg_rule_params, self._adv_scale, fl.staleness_discount,
               fl.agg_block_c, fl.agg_block_d)
        if key not in self._server_steps:
            self._server_steps[key] = R.make_server_round_step(
                self._template, local_steps=self.sim_cfg.local_steps,
                agg_impl=fl.agg_impl, agg_rule=fl.agg_rule,
                agg_rule_params=fl.agg_rule_params,
                adversary_scale=self._adv_scale,
                staleness_discount=fl.staleness_discount,
                uses_cache=bool(uses_cache), block_c=fl.agg_block_c,
                block_d=fl.agg_block_d)
        return self._server_steps[key]

    # -- robust-aggregation state / adversary plumbing ----------------------

    def _init_rule_state(self):
        """Fresh per-run (N,) rule state (stateful rules only) on the
        engine's device, threaded through the step like the caches."""
        if not self._agg_stateful:
            return None
        return torch.from_numpy(self._agg_rule.init_state(
            self.fl_cfg.num_clients)).to(self.device)

    def _step_extra(self, rule_state):
        """Trailing arguments of the server step: the malicious mask
        (model-poisoning adversary), then the rule state."""
        extra = ()
        if self._adv_scale is not None:
            extra += (self._malicious,)
        if self._agg_stateful:
            extra += (rule_state,)
        return extra

    def run(self, policy: Union[str, Policy], rounds: Optional[int] = None,
            time_budget: Optional[float] = None, eval_every: int = 1,
            progress: Optional[Callable] = None, diagnostics: bool = True,
            explore_uniforms: Optional[Callable] = None) -> History:
        """Run FL rounds.  ``time_budget`` (simulated seconds) caps the run
        by wall clock instead of round count; ``rounds`` (default
        ``sim_cfg.rounds``) remains the hard round cap.
        ``diagnostics=False`` skips the end-of-run per-class/per-client
        accuracy sweep.

        ``explore_uniforms``: optional ``rnd -> (N,) float32`` callable
        giving each round's explore noise.  By default the engine draws it
        from a CPU ``torch.Generator`` seeded with ``sim_cfg.seed``, so the
        run is the same on the CPU and on the card; a test passes the
        reference's ``jax.random`` numbers here."""
        sim_cfg, fl_cfg = self.sim_cfg, self.fl_cfg
        N = fl_cfg.num_clients
        fleet = self._fleet if self._fleet is not None else Fleet(sim_cfg)
        if isinstance(policy, str):
            policy = make_policy(policy, sim_cfg, fl_cfg, fleet,
                                 device=self.device)
        if explore_uniforms is None:
            gen = torch.Generator().manual_seed(sim_cfg.seed)

            def explore_uniforms(rnd):
                return torch.rand((N,), generator=gen).numpy()

        state = policy.init_state()
        n_rounds = sim_cfg.rounds if rounds is None else rounds
        hist = History()
        with torch.no_grad():
            global_params = self._template
            caches = self._fresh_caches(global_params)
            state, global_params, caches, rule_state = self._host_rounds(
                policy, state, fleet, hist, global_params, caches,
                self._init_rule_state(), explore_uniforms, n_rounds,
                time_budget, eval_every, progress)

            # a time_budget break can land between eval boundaries: force
            # a measurement on the final global model
            if time_budget is not None and hist.eval_mask \
                    and not hist.eval_mask[-1]:
                hist.acc[-1] = self._accuracy(global_params)
                hist.eval_mask[-1] = True

            # final diagnostics (paper Fig. 1(b)(c))
            if diagnostics:
                hist.per_class_acc = to_host(CLF.clf_per_class_accuracy(
                    global_params, self._test_x, self._test_y,
                    self.data.num_classes))
                n = min(N, self.data.x.shape[0])
                x = torch.as_tensor(self.data.x[:n], dtype=torch.float32,
                                    device=self.device)
                y = torch.as_tensor(self.data.y[:n],
                                    device=self.device).long()
                hist.per_client_acc = to_host(
                    CLF.clf_accuracy(global_params, x, y)).astype(
                        np.float64)
        for k, v in policy.history_extras(state).items():
            setattr(hist, k, v)
        if rule_state is not None:
            # the one read-back of the trust scores, at run end
            hist.trust = to_host(rule_state)
        hist.final_params = global_params
        self._last_caches = caches
        return hist

    # -- host-side round closing / bookkeeping ------------------------------

    def _close_round(self, times, plan, policy):
        """Round termination (Algorithm 2 lines 13–16) on the per-device
        finish times."""
        return R.host_round_cut(times, float(plan.quorum),
                                self.sim_cfg.round_deadline,
                                policy.waits_for_stragglers)

    def _validate_plan(self, plan):
        """Per-round plan admission.  Plans built through
        ``RoundPlan.create`` already ran their checks — only fleet-size
        agreement and the scan-length cap are left to confirm."""
        fl_cfg, sim_cfg = self.fl_cfg, self.sim_cfg
        if getattr(plan, "_validated", False):
            if plan.selected.shape[0] != fl_cfg.num_clients:
                raise ValueError(
                    f"RoundPlan sized {plan.selected.shape[0]} for a "
                    f"{fl_cfg.num_clients}-client fleet")
            so = plan.steps_override
            if so is not None and to_host(so).size \
                    and int(to_host(so).max()) > sim_cfg.local_steps:
                raise ValueError(
                    f"RoundPlan.steps_override requests up to "
                    f"{int(to_host(so).max())} local steps but the "
                    f"trainer scans only {sim_cfg.local_steps}")
        else:
            plan.validate(fl_cfg.num_clients,
                          local_steps=sim_cfg.local_steps)

    def _book_round(self, hist, rnd, n_rounds, eval_every, global_params,
                    downloads, received, selected, duration, cum_comm,
                    cum_time, acc, progress):
        """Comm/time accumulation, eval cadence and the History appends
        for one round; returns the updated ``(cum_comm, cum_time, acc)``.
        ``downloads`` is the distribute mask gated by the round's online
        mask (§4.4 only transmits to reachable devices)."""
        cum_comm += (downloads.sum() + received.sum()) \
            * self.sim_cfg.model_mb
        cum_time += duration
        evaluated = rnd % eval_every == 0 or rnd == n_rounds - 1
        if evaluated:
            acc = self._accuracy(global_params)
        hist.acc.append(acc)
        hist.eval_mask.append(evaluated)
        hist.comm_mb.append(cum_comm)
        hist.wall_clock.append(cum_time)
        hist.received.append(int(received.sum()))
        hist.selected.append(int(selected.sum()))
        if progress and (rnd % 10 == 0 or rnd == n_rounds - 1):
            progress(rnd, acc, cum_comm, cum_time)
        return cum_comm, cum_time, acc

    # -- host-RNG round loop (bernoulli_host) -------------------------------

    def _host_rounds(self, policy, state, fleet, hist, global_params,
                     caches, rule_state, explore_uniforms, n_rounds,
                     time_budget, eval_every, progress):
        """The seed simulator's numpy round loop, draw for draw the
        reference's ``_host_rounds``."""
        sim_cfg, fl_cfg = self.sim_cfg, self.fl_cfg
        N = fl_cfg.num_clients
        # adaptive cache frequency (C3): steps between cache writes
        cache_every_np = np.clip(np.round(to_host(
            C.adaptive_cache_interval(2.0, fleet.battery,
                                      fleet.stability))), 1, 4
        ).astype(np.int32) if policy.uses_cache else \
            np.full(N, BIG, np.int32)
        cache_every = self._put(cache_every_np)

        cum_comm = 0.0
        cum_time = 0.0
        acc = float("nan")
        full_steps = np.full(N, sim_cfg.local_steps, np.int32)
        ones_w = torch.ones((N,), dtype=torch.float32, device=self.device)
        server_step = self._server_step(policy.uses_cache)

        for rnd in range(n_rounds):
            if time_budget is not None and cum_time >= time_budget:
                break
            online = fleet.online_mask()
            state, plan = policy.plan(
                state, RoundObservation(rnd, online, caches,
                                        explore_uniforms(rnd)))
            self._validate_plan(plan)
            selected = to_host(plan.selected)
            distribute = to_host(plan.distribute)
            resume = to_host(plan.resume)

            # per-device workload (override clamped to the scan length)
            prior_steps = np.round(
                to_host(caches.progress) * sim_cfg.local_steps
            ).astype(np.int32)
            base_steps = full_steps if plan.steps_override is None \
                else np.minimum(to_host(plan.steps_override),
                                sim_cfg.local_steps)
            steps_needed = np.where(resume,
                                    np.maximum(base_steps - prior_steps, 1),
                                    base_steps).astype(np.int32)
            steps_needed = np.where(selected, steps_needed, 0)

            # failures (exposure-scaled) + interruption points
            fail = fleet.failure_draw(
                steps_needed / max(sim_cfg.local_steps, 1))
            fail &= selected
            stop = np.where(fail, fleet.failure_step(steps_needed), BIG)

            # local training; the start state (fresh global vs cached
            # local) is picked on the device inside the trainer
            final, cache_p, cached_steps, losses = self.trainer(
                global_params, caches, self._put(resume),
                self._put(steps_needed), self._put(stop), cache_every)

            # timing + round termination
            success = selected & ~fail & (steps_needed > 0)
            completed = np.minimum(steps_needed, stop)
            times = fleet.round_times(steps_needed, distribute, completed,
                                      success)
            t_cut, duration = self._close_round(times, plan, policy)
            received = success & (times <= t_cut)

            # server step (§4.3 hot path): aggregation weights with the
            # staleness discount for stale BASE models, the adversary's
            # poison, packed whole-model aggregation under the rule (one
            # fed_agg launch for the mean), C3 cache write/clear
            extra_w = ones_w if plan.agg_weights is None else \
                self._put(to_host(plan.agg_weights).astype(np.float32))
            out = server_step(
                global_params, caches, final, cache_p, cached_steps,
                self._put(selected), self._put(fail), self._put(received),
                self._put(resume), self._n_samples, extra_w, rnd,
                *self._step_extra(rule_state))
            if self._agg_stateful:
                global_params, caches, rule_state = out
            else:
                global_params, caches = out

            state = policy.observe(
                state, plan,
                RoundReport(received=received, fail=fail,
                            losses=to_host(losses), durations=times,
                            duration=duration, rnd=rnd))

            cum_comm, cum_time, acc = self._book_round(
                hist, rnd, n_rounds, eval_every, global_params,
                distribute & online, received, selected, duration,
                cum_comm, cum_time, acc, progress)
        return state, global_params, caches, rule_state

