"""FleetEngine: the FL round loop behind the typed policy API.

The port of ``repro.fl.engine`` on one device.  The engine owns the local
trainer, the per-round server step (weights, the adversary's poison,
packed aggregation under the configured rule through the hand-written
``fed_agg`` and ``residual_norms`` kernels, C3 cache bookkeeping) and
the fleet simulator; policies are ``plan``/``observe``
transitions over ``RoundPlan``/``RoundReport``.

``FLConfig.dynamics`` picks the round loop.  ``bernoulli_host`` (the
default) runs the seed simulator's host-RNG loop: the host sees (N,)-sized
masks each round.  Every other registered process
(``repro_torch.fleet``) runs the device round loop: the availability
draw, workload, failures, timing model and the round cut run on the
engine's device, History bookkeeping is deferred through a
``_RoundLedger``, and ``FLConfig.pipeline_depth`` > 1 lets the host queue
round k+1 while round k still runs on the card.  Rows are the same at
every depth.  On that loop ``FLConfig.cohort_size`` runs each round over
the selected clients' (X, ...) rows, and ``FLConfig.cache_offload`` keeps
the C3 cache params on the host (``core/cache_store.py``).

``run(telemetry=...)`` (or ``FLConfig.telemetry``) adds the device
metrics of ``repro_torch.obs`` to the ledger's read-back row and host
spans around each seam of the round; ``FLConfig.debug_checks`` adds the
round guard and the rebuild detector of ``repro_torch.analysis.runtime``.

Global params and client caches stay on the engine's device across
rounds.  The engine runs on the CUDA card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import aggregation as AGG
from repro_torch.core import caching as C
from repro_torch.core import round as R
from repro_torch.core.cache_store import (CohortCacheStream, HostCacheStore,
                                          TransferStats)
from repro_torch.core.agg_rules import make_agg_rule
from repro_torch.core.dependability import BetaBelief, sample_dependability
from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import FederatedClassification
from repro_torch.device import host_readback, resolve_device
from repro_torch.fl import classifier as CLF
from repro_torch.fl import policies as _builtin_policies  # noqa: F401
from repro_torch.fl.api import (Policy, RoundObservation, RoundReport,
                                cohort_index, cohort_overflow, make_policy,
                                to_host)
from repro_torch.fl.simulator import Fleet, SimConfig, place_per_client
from repro_torch.fleet import (draw_noise, get_dynamics, make_adversary,
                               make_dynamics)
from repro_torch.obs import metrics as OM
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BIG = 1 << 20
# the default Thompson generator's seed is sim_cfg.seed + this
THOMPSON_SALT = 0x7B5


# ---------------------------------------------------------------------------
# Vectorized local trainer
# ---------------------------------------------------------------------------

def make_trainer(sim_cfg: SimConfig, data: FederatedClassification,
                 device="cpu", dynamics_features=None,
                 cohort_size: Optional[int] = None):
    """Build the all-fleet local trainer over the client training set,
    placed once on ``device``.

    Plain PyTorch, no kernel of its own (the reference leaves it to XLA):
    the stacked per-client models run through ``torch.bmm``, and one
    ``torch.autograd.grad`` of the sum of the per-client mean losses gives
    every client exactly its own gradient — the clients' parameters are
    independent, so the sum's gradient with respect to client i's
    parameters is the gradient of client i's loss.

    ``dynamics_features``: a ``repro_torch.fleet.FleetFeatures`` switches
    to the device dynamics variant (``train_all_dyn``): the round's
    workload (steps from cache progress), exposure-scaled failures and
    interruption points (from the ``FleetDraw`` variates) and the
    per-device timing model run with the training on the device, so
    nothing is drawn on the host and nothing (N,)-sized is uploaded per
    round.

    ``cohort_size`` (X, dynamics variant only): the compact-cohort round
    body (``train_cohort_dyn``).  Given the cohort index (``cohort_index``
    of the plan's selection mask), the clients' data, caches, draw and
    plan rows are gathered into (X, ...) blocks, and the local steps run
    over X rows instead of N.  Under host offload the caller hands in the
    cohort's (X, ...) cache params, fetched from the host store, and
    ``caches`` carry metadata only; every other op is the resident
    path's, so its outputs are the same.  It returns the (X,) blocks the
    cohort cut and server step take and (N,) report views for the
    policies.
    """
    if cohort_size is not None and dynamics_features is None:
        raise ValueError("cohort_size requires the dynamics trainer "
                         "variant (pass dynamics_features)")
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

    if dynamics_features is None:
        return train_all

    steps_per_sec = dynamics_features.steps_per_sec
    model_mb = sim_cfg.model_mb
    # the reference's jitted ``steps / max_steps``: XLA multiplies by the
    # float32 reciprocal of the constant
    inv_steps = float(np.float32(1.0) / np.float32(max(max_steps, 1)))

    def round_body(x_arr, y_arr, steps_per_sec, global_params, caches,
                   draw, selected, distribute, resume, base_steps,
                   cache_every):
        """Workload + failures + training + timing over one client axis:
        the full fleet, or a gathered cohort block (every input aligned
        along dim 0)."""
        # clamp to the scan length: an oversized steps_override would
        # otherwise charge un-run steps in the timing model below
        base_steps = base_steps.clamp_max(max_steps)
        prior = torch.round(caches.progress * max_steps).to(torch.int32)
        steps_needed = torch.where(resume, (base_steps - prior).clamp_min(1),
                                   base_steps)
        steps_needed = torch.where(selected, steps_needed, 0).to(torch.int32)
        fail = draw.failure_mask(steps_needed * inv_steps) & selected
        stop = torch.where(fail, draw.interruption_step(steps_needed), BIG)
        start_params = C.resume_params(caches, global_params, resume)
        params, cache, cached_steps, mean_loss = local_scan(
            x_arr, y_arr, start_params, steps_needed, stop, cache_every)
        # timing model (Algorithm 2 lines 13–16) on the round's bandwidth;
        # tensor / tensor divides exactly, as XLA does here (a python
        # number over a tensor is a reciprocal times the number in torch)
        success = selected & ~fail & (steps_needed > 0)
        completed = torch.minimum(steps_needed, stop)
        comm = torch.full_like(draw.bandwidth, model_mb * 8.0) \
            / draw.bandwidth
        t = torch.where(distribute, comm, 0.0) \
            + completed / steps_per_sec \
            + torch.where(success, comm, 0.0)
        times = torch.where(success, t, math.inf)
        return (params, cache, cached_steps, mean_loss, steps_needed, fail,
                success, times)

    if cohort_size is None:
        def train_all_dyn(global_params, caches, draw, selected,
                          distribute, resume, base_steps, cache_every):
            """Dynamics round body: workload + failures + training +
            timing.

            draw:       ``repro_torch.fleet.FleetDraw`` of this round.
            selected/distribute/resume: (N,) bool plan masks.
            base_steps: (N,) int planned steps before resume credit.
            Returns (final_params, cache_params, cached_steps, mean_loss,
            steps_needed, fail, success, times) — times in simulated
            seconds, inf where the device never uploads.
            """
            return round_body(x_all, y_all, steps_per_sec, global_params,
                              caches, draw, selected, distribute, resume,
                              base_steps, cache_every)

        return train_all_dyn

    X = int(cohort_size)
    N = x_all.shape[0]

    def train_cohort_dyn(global_params, caches, cache_params_x, idx, draw,
                         selected, distribute, resume, base_steps,
                         cache_every):
        """Compact-cohort dynamics round body: gather → (X, ...) round
        body → (N,) report views.  ``idx`` is the (X,) cohort index;
        ``cache_params_x`` is None on the resident path (the cohort's
        slots are gathered from the (N, ...) caches) or the fetched
        (X, ...) block under offload; the other inputs are
        ``train_all_dyn``'s (N,) ones.  Returns ``(final_params_x,
        cache_params_x, cached_steps_x, mean_loss_x, steps_needed_x,
        fail_x, success_x, times_x, losses_n, fail_n, times_n)``."""
        def take(a, fill):
            return C.take_rows(a, idx, fill)

        def scatter_n(values, fill):
            """An (N,) report view: the cohort rows at ``idx``, ``fill``
            elsewhere (what the full scan computes for an idle
            client)."""
            out = C.spare_rows(N, (), fill, values.dtype, values.device)
            return C.scatter_rows(out, idx, values)

        if cache_params_x is None:
            caches_x = C.gather_caches(caches, idx)
        else:
            caches_x = C.ClientCaches(cache_params_x,
                                      take(caches.progress, 0.0),
                                      take(caches.round_stamp, -1))
        (params, cache, cached_steps, mean_loss, steps_needed, fail,
         success, times) = round_body(
            take(x_all, 0.0), take(y_all, 0), take(steps_per_sec, 1.0),
            global_params, caches_x, draw.take(idx),
            take(selected, False), take(distribute, False),
            take(resume, False), take(base_steps, 0),
            take(cache_every, 1))
        return (params, cache, cached_steps, mean_loss, steps_needed, fail,
                success, times, scatter_n(mean_loss, 0.0),
                scatter_n(fail, False), scatter_n(times, math.inf))

    return train_cohort_dyn


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
    # telemetry: metric column -> per-round values (None with it off)
    metrics: Optional[dict] = None

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
        if self.metrics is not None:
            d["metrics"] = {k: list(v) for k, v in self.metrics.items()}
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
        if d.get("metrics") is not None:
            h.metrics = {k: list(v) for k, v in d["metrics"].items()}
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


def metric_layout(metrics: dict) -> tuple:
    """The column layout of one round's metric values in the ledger's
    row: ``(name, numel, is_vector, is_int)`` per column, from shapes and
    dtypes alone (the same for every round of one metrics function)."""
    return tuple((k, v.numel(), v.dim() > 0, not v.is_floating_point())
                 for k, v in metrics.items())


def unpack_metrics(layout: tuple, vals: list) -> dict:
    """Python values of one round's metrics from their row slice:
    counts as ints, the rest as floats, vectors as lists."""
    out, i = {}, 0
    for name, n, vector, is_int in layout:
        got = [int(v) if is_int else float(v) for v in vals[i:i + n]]
        out[name] = got if vector else got[0]
        i += n
    return out


def _record_metrics(hist: History, telemetry, rnd: int, evaluated: bool,
                    acc: float, duration: float, cum_comm: float,
                    cum_time: float, received: int, downloads: int,
                    selected: int, mvals: dict) -> None:
    """One round's metric values onto ``hist.metrics`` and, with a
    telemetry session, its ``round`` event — the one event format of
    both round loops."""
    for k, v in mvals.items():
        hist.metrics.setdefault(k, []).append(v)
    if telemetry is not None:
        telemetry.record_round({
            "round": rnd, "evaluated": evaluated,
            "acc": None if acc != acc else acc,
            "duration": duration, "comm_mb": cum_comm,
            "wall_clock": cum_time, "received": received,
            "downloads": downloads, "selected": selected, **mvals})


class _RoundLedger:
    """Deferred History bookkeeping of the device round loop.

    Each round the loop hands over the device scalars one History row
    needs — the round cut and its capped flag, the received / download /
    selected counts and, at eval boundaries, the test accuracy — and,
    with telemetry on, the round's metric values.  ``push`` packs them
    into one float64 tensor (every count and float32 value is exact
    there, vectors flattened in the metrics' fixed column order) and, on
    a card, starts its copy into pinned host memory without waiting,
    recording an event behind it.  ``resolve(keep)`` reads rows back
    oldest first until ``keep`` remain in flight, waiting only for each
    row's own event — the work queued after it keeps running.  The loop
    calls it with ``keep = pipeline_depth - 1``, with ``keep=0`` at run
    end, at ``progress`` ticks and every round under a ``time_budget``.

    The float64 sums of comm and wall clock happen here on the host over
    exact values — a capped round bills the exact configured
    ``round_deadline`` — so rows are the same at every depth.

    A compact-cohort round also pushes its overflow flag (more clients
    selected than ``cohort_size``): it rides the same read-back, and
    ``resolve`` raises a ``RuntimeError`` naming the policy when it is
    set — under ``pipeline_depth`` d up to d - 1 rounds after the round.
    Metric values land on ``History.metrics`` and, with a telemetry
    session, in its ``round`` events.
    """

    def __init__(self, hist: History, model_mb: float, round_deadline: float,
                 progress: Optional[Callable], n_rounds: int, device,
                 cohort_info: Optional[tuple] = None, telemetry=None,
                 tracer=obs.NULL_TRACER):
        self.hist = hist
        self.cohort_info = cohort_info    # (policy name, cohort size)
        self.model_mb = model_mb
        self.round_deadline = round_deadline
        self.progress = progress
        self.n_rounds = n_rounds
        self.device = torch.device(device)
        self.telemetry = telemetry        # repro_torch.obs.Telemetry | None
        self.tracer = tracer
        self.pending: List[tuple] = []
        self.cum_comm = 0.0
        self.cum_time = 0.0
        self.acc = float("nan")

    def push(self, rnd, evaluated, duration, capped, received, downloads,
             selected, acc=None, overflow=None, metrics=None):
        """Queue one round's device scalars (``acc`` only when the round
        was evaluated, ``overflow`` only on a compact-cohort round,
        ``metrics`` only with telemetry on)."""
        vals = [duration, capped, received, downloads, selected]
        if overflow is not None:
            vals.append(overflow)
        if evaluated:
            vals.append(acc)
        packed = torch.stack([v.to(torch.float64) for v in vals])
        layout = None
        if metrics is not None:
            layout = metric_layout(metrics)
            packed = torch.cat([packed] + [v.reshape(-1).to(torch.float64)
                                           for v in metrics.values()])
        event = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            packed = host
        self.pending.append((rnd, evaluated, overflow is not None, packed,
                             event, layout))

    def resolve(self, keep: int = 0):
        """Read back all but the newest ``keep`` rounds."""
        while len(self.pending) > keep:
            rnd, evaluated, cohort, packed, event, layout = \
                self.pending.pop(0)
            with self.tracer.span("ledger_resolve", round=rnd), \
                    host_readback(self.device):
                if event is not None:
                    event.synchronize()
                vals = packed.tolist()
            head = 5 + cohort + evaluated
            duration, capped, received, downloads, selected = vals[:5]
            if cohort and vals[5]:
                name, x = self.cohort_info
                raise RuntimeError(
                    f"cohort overflow in round {rnd}: policy {name!r} "
                    f"selected {int(selected)} clients but "
                    f"FLConfig.cohort_size={x} — the compact round "
                    f"trained a truncated cohort.  Raise cohort_size "
                    f"(or set it to None for the full scan).")
            self.cum_comm += (int(downloads) + int(received)) \
                * self.model_mb
            billed = self.round_deadline if capped else duration
            self.cum_time += billed
            if evaluated:
                self.acc = vals[head - 1]
            hist = self.hist
            hist.acc.append(self.acc)
            hist.eval_mask.append(evaluated)
            hist.comm_mb.append(self.cum_comm)
            hist.wall_clock.append(self.cum_time)
            hist.received.append(int(received))
            hist.selected.append(int(selected))
            _record_metrics(
                hist, self.telemetry, rnd, evaluated, self.acc, billed,
                self.cum_comm, self.cum_time, int(received),
                int(downloads), int(selected),
                {} if layout is None else unpack_metrics(layout,
                                                         vals[head:]))
            if self.progress and (rnd % 10 == 0
                                  or rnd == self.n_rounds - 1):
                self.progress(rnd, self.acc, self.cum_comm, self.cum_time)


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

    ``FLConfig.cohort_size`` (X) runs each device-loop round over the
    selected clients' (X, ...) rows; ``FLConfig.cache_offload`` keeps the
    C3 cache params in ``engine.cache_store`` on the host and streams the
    cohort's (X, D) block each round (``engine.transfer_stats`` counts
    the copies).  Neither changes a History row.
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
        # telemetry (repro_torch.obs): metrics functions memoised per
        # (level, round path); the run's tracer, NULL_TRACER with it off
        self._metrics_fns = {}
        self._tracer = obs.NULL_TRACER
        # debug_checks (repro_torch.analysis.runtime), built on first use
        self.debug_checks = bool(fl_cfg.debug_checks)
        self._round_guards = {}
        self._rebuild_detector = None
        self._last_caches = None  # previous run's fleet caches (recycled)
        self.pipeline_depth = int(fl_cfg.pipeline_depth)
        self.cohort = fl_cfg.cohort_size
        self.offload = fl_cfg.cache_offload
        if self.cohort is not None \
                and get_dynamics(fl_cfg.dynamics).host_side:
            raise ValueError(
                f"FLConfig.cohort_size requires a device dynamics "
                f"process, but {fl_cfg.dynamics!r} is host-side — the "
                f"numpy round loop has no compact path (pick a device "
                f"process, e.g. 'bernoulli', or set cohort_size=None)")
        # device dynamics (repro_torch.fleet): the process and its trainer
        # are memoized per (process, params), the per-run (N,) constants
        # and the round cut per policy trait — placed once and reused, so
        # steady-state rounds upload nothing
        get_dynamics(fl_cfg.dynamics)          # fail fast on unknown names
        self._dyn_cache = {}
        self._round_consts = {}
        self._cut_fns = {}
        # the device round loop's final process state and draw (kept on
        # the device between runs, like the caches)
        self._last_fleet_state = None
        self._last_draw = None
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
        # host-offloaded C3 caches: the (N, D) params live in a sparse host
        # store, the card holds (N,) metadata and the round's (X, D) block
        self.cache_store = None
        self._cache_stream = None
        self._zeros_x = None
        self._transfer_stats = TransferStats()
        if self.offload is not None:
            bound = fl_cfg.cache_staleness_bound \
                if self.offload == "discard" else None
            self.cache_store = HostCacheStore(
                self._template, fl_cfg.num_clients, staleness_bound=bound)
            self._cache_stream = CohortCacheStream(
                self.cache_store, self.cohort, self.device,
                stats=self._transfer_stats)

    @property
    def transfer_stats(self) -> TransferStats:
        """This engine's offload-stream transfer counters (all zero
        without an offload stream)."""
        return self._transfer_stats

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

    def _eval(self, params) -> torch.Tensor:
        """Test accuracy as a 0-d tensor on the engine's device."""
        return CLF.clf_accuracy(params, self._test_x, self._test_y)

    def _fresh_caches(self, template):
        """Empty (N, ...) C3 cache state for a new run.  The previous
        run's caches are reset in place: nothing outside the engine holds
        them, and the fill reuses their O(N·D) buffers.  Under offload
        the caches are (N,) metadata only, and the host store (with any
        write-back still queued) is emptied."""
        spent, self._last_caches = self._last_caches, None
        if self.offload is not None:
            self._cache_stream.reset()
            template = {}
        if spent is not None:
            return C.reset_caches(spent)
        return C.init_caches(template, self.fl_cfg.num_clients,
                             device=self.device)

    def _server_step(self, uses_cache: bool):
        # keyed by everything that changes the step
        fl = self.fl_cfg
        key = (bool(uses_cache), fl.agg_impl, fl.agg_rule,
               fl.agg_rule_params, self._adv_scale, fl.staleness_discount,
               fl.agg_block_c, fl.agg_block_d, self.cohort, self.offload)
        if key not in self._server_steps:
            self._server_steps[key] = R.make_server_round_step(
                self._template, local_steps=self.sim_cfg.local_steps,
                agg_impl=fl.agg_impl, agg_rule=fl.agg_rule,
                agg_rule_params=fl.agg_rule_params,
                adversary_scale=self._adv_scale,
                staleness_discount=fl.staleness_discount,
                uses_cache=bool(uses_cache), block_c=fl.agg_block_c,
                block_d=fl.agg_block_d, cohort_size=self.cohort,
                cache_offload=self.offload)
        return self._server_steps[key]

    # -- robust-aggregation state / adversary plumbing ----------------------

    def _init_rule_state(self):
        """Fresh per-run (N,) rule state (stateful rules only) on the
        engine's device, threaded through the step like the caches.  With
        a cohort it is a ``spare_rows`` view: the step scatters the
        cohort's rows back in place."""
        if not self._agg_stateful:
            return None
        n = self.fl_cfg.num_clients
        if self.cohort is None:
            return place_per_client(self._agg_rule.init_state(n),
                                    self.device)
        return place_per_client(self._agg_rule.init_state(n + 1),
                                self.device)[:n]

    def _step_extra(self, rule_state):
        """Trailing arguments of the server step: the malicious mask
        (model-poisoning adversary), then the rule state."""
        extra = ()
        if self._adv_scale is not None:
            extra += (self._malicious,)
        if self._agg_stateful:
            extra += (rule_state,)
        return extra

    def server_step_memory(self, uses_cache: bool = True) -> dict:
        """Memory profile of the active server step (bytes).

        With ``FLConfig.cohort_size`` the trainer outputs and the packed
        aggregation buffer are (X, ...) blocks: ``packed_rows`` /
        ``packed_buffer_bytes`` say which buffer the step packs.
        ``rule_state_bytes`` is the stateful rule's (N,) vector (0 for
        stateless rules).  ``cache_device_bytes`` / ``cache_host_bytes``
        split the C3 caches: resident, all of the (N, ...) caches on the
        device and none on the host; under ``cache_offload`` the device
        holds (N,) metadata plus the round's (X, D) block, the host the
        store's live rows.

        ``peak_live_bytes``: no XLA memory analysis exists here, so it is
        the bytes of the step's tensor inputs plus its outputs, each
        storage counted once (the cohort steps write the caches in place
        and return them), from one call of the step on representative
        zero inputs — the same way on the CPU and on the card.  On the
        card that call launches the step's kernels once."""
        N = self.fl_cfg.num_clients
        rows = N if self.cohort is None else int(self.cohort)
        meta_only = self.offload is not None
        dev = self.device
        step = self._server_step(uses_cache)
        caches = C.init_caches({} if meta_only else self._template, N,
                               device=dev)
        stacked = tree_map(lambda a: torch.zeros(
            (rows,) + tuple(a.shape), dtype=a.dtype, device=dev),
            self._template)
        mask = torch.zeros((rows,), dtype=torch.bool, device=dev)
        steps_i = torch.zeros((rows,), dtype=torch.int32, device=dev)
        ones = torch.ones((N,), dtype=torch.float32, device=dev)
        rule_state = self._init_rule_state()
        if self.cohort is None:
            args = (self._template, caches, stacked, stacked, steps_i, mask,
                    mask, mask, mask, self._n_samples, ones, 0)
        else:
            idx = torch.arange(rows, device=dev)
            mask_n = torch.zeros((N,), dtype=torch.bool, device=dev)
            params = (stacked,) if meta_only else (stacked, stacked)
            args = (self._template, caches, *params, steps_i, idx, mask_n,
                    mask, mask, mask_n, self._n_samples, ones, 0)
        args += self._step_extra(rule_state)
        with torch.no_grad():
            outs = step(*args)

        def storages(tree, seen):
            if isinstance(tree, torch.Tensor):
                st = tree.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
            elif isinstance(tree, dict):
                for v in tree.values():
                    storages(v, seen)
            elif isinstance(tree, (list, tuple)):
                for v in tree:
                    storages(v, seen)
            return seen

        def nbytes(t):
            return t.numel() * t.element_size()

        layout = AGG.pack_layout(self._template)
        meta_bytes = nbytes(caches.progress) + nbytes(caches.round_stamp)
        out = {"peak_live_bytes": sum(storages((args, outs), {}).values()),
               "packed_rows": rows,
               "packed_buffer_bytes": rows * layout.dim * 4,
               "rule_state_bytes": 0 if rule_state is None
               else nbytes(rule_state)}
        if meta_only:
            out["cache_device_bytes"] = meta_bytes \
                + rows * self.cache_store.row_bytes
            out["cache_host_bytes"] = self.cache_store.nbytes
        else:
            out["cache_device_bytes"] = meta_bytes + sum(
                nbytes(l) for l in tree_leaves(caches.params))
            out["cache_host_bytes"] = 0
        return out

    def run(self, policy: Union[str, Policy], rounds: Optional[int] = None,
            time_budget: Optional[float] = None, eval_every: int = 1,
            progress: Optional[Callable] = None, diagnostics: bool = True,
            explore_uniforms: Optional[Callable] = None,
            dynamics_noise: Optional[Callable] = None,
            thompson_draws: Optional[Callable] = None,
            telemetry=None) -> History:
        """Run FL rounds.  ``time_budget`` (simulated seconds) caps the run
        by wall clock instead of round count; ``rounds`` (default
        ``sim_cfg.rounds``) remains the hard round cap.
        ``diagnostics=False`` skips the end-of-run per-class/per-client
        accuracy sweep.

        ``FLConfig.dynamics`` picks the round loop: ``bernoulli_host`` the
        host-RNG loop, any other registered process the device round loop
        (see the module docstring).

        ``explore_uniforms``: optional ``rnd -> (N,) float32`` callable
        giving each round's explore noise.  By default the host loop draws
        it from a CPU ``torch.Generator`` seeded with ``sim_cfg.seed`` (the
        run is the same on the CPU and on the card) and the device loop
        from a generator on the engine's device, so its rounds read
        nothing from the host; a test passes the reference's
        ``jax.random`` numbers here.

        ``dynamics_noise``: the device loop's process uniforms, an
        optional callable mapping ``"init"`` and then each round index to
        a dict of the (N,) float32 uniforms the process names
        (``init_noise`` / ``step_noise``).  By default they come from a
        generator on the engine's device seeded from ``sim_cfg.seed``.

        ``thompson_draws``: under ``FLConfig.selection_mode="thompson"``,
        an optional ``(rnd, alpha, beta) -> (N,) float32`` callable giving
        each round's Beta sample of the beliefs the policy plans from.  By
        default both loops sample on the engine's device from a generator
        seeded with ``sim_cfg.seed + THOMPSON_SALT``.  (Under Thompson
        the reference splits the round key first, ``(k', k_ts) =
        split(k)``, and draws the explore uniforms from ``k'``.)

        ``telemetry``: None defers to ``FLConfig.telemetry``; False turns
        it off for this run; "basic" / "full" runs a bare session at that
        level; a ``repro_torch.obs.Telemetry`` is used as it is (sinks,
        trace file and profiler window included).  Metric values land on
        ``History.metrics``."""
        sim_cfg, fl_cfg = self.sim_cfg, self.fl_cfg
        N = fl_cfg.num_clients
        fleet = self._fleet if self._fleet is not None else Fleet(sim_cfg)
        if isinstance(policy, str):
            policy = make_policy(policy, sim_cfg, fl_cfg, fleet,
                                 device=self.device)
        if self.cohort is not None:
            bound = policy.selection_bound()
            if bound > self.cohort:
                raise ValueError(
                    f"policy {policy.name!r} can select up to {bound} "
                    f"clients per round but FLConfig.cohort_size="
                    f"{self.cohort} — the compact round path would "
                    f"truncate its cohort.  Raise cohort_size to at "
                    f"least {bound} (or set it to None for the full "
                    f"scan).")
        host_side = get_dynamics(fl_cfg.dynamics).host_side
        if explore_uniforms is None and host_side:
            gen = torch.Generator().manual_seed(sim_cfg.seed)

            def explore_uniforms(rnd):
                return torch.rand((N,), generator=gen).numpy()

        state = policy.init_state()
        n_rounds = sim_cfg.rounds if rounds is None else rounds
        hist = History()
        tel = self._resolve_telemetry(telemetry)
        tracer = obs.NULL_TRACER if tel is None else tel.tracer
        self._tracer = tracer
        if tel is not None:
            tel.open_run({"policy": policy.name, "num_clients": N,
                          "rounds": n_rounds, "dynamics": fl_cfg.dynamics,
                          "cohort_size": fl_cfg.cohort_size,
                          "cache_offload": fl_cfg.cache_offload,
                          "pipeline_depth": fl_cfg.pipeline_depth,
                          "selection_mode": fl_cfg.selection_mode})
            hist.metrics = {}
        thompson = self._thompson_source(thompson_draws)
        with torch.no_grad():
            global_params = self._template
            caches = self._fresh_caches(global_params)
            with tracer.span("rounds"):
                if host_side:
                    state, global_params, caches, rule_state = \
                        self._host_rounds(
                            policy, state, fleet, hist, global_params,
                            caches, self._init_rule_state(),
                            explore_uniforms, thompson, n_rounds,
                            time_budget, eval_every, progress, tel)
                else:
                    state, global_params, caches, rule_state = \
                        self._device_rounds(
                            policy, state, fleet, hist, global_params,
                            caches, self._init_rule_state(),
                            explore_uniforms, dynamics_noise, thompson,
                            n_rounds, time_budget, eval_every, progress,
                            tel)
            if self.debug_checks:
                self._debug_rebuild_check(policy, tel)
            hist = self._run_end(policy, state, hist, global_params,
                                 rule_state, time_budget, diagnostics)
        if tel is not None:
            final_acc = hist.acc[-1] if hist.acc else None
            tel.close_run({
                "policy": policy.name, "rounds": len(hist.acc),
                "final_acc": None if final_acc is None
                or final_acc != final_acc else final_acc,
                "comm_mb": hist.comm_mb[-1] if hist.comm_mb else 0.0,
                "wall_clock": hist.wall_clock[-1] if hist.wall_clock
                else 0.0,
                "transfer_stats": self._transfer_stats.snapshot()})
            self._tracer = obs.NULL_TRACER
        hist.final_params = global_params
        self._last_caches = caches
        return hist

    def _run_end(self, policy, state, hist, global_params, rule_state,
                 time_budget, diagnostics) -> History:
        """The run-end read-back: a forced final eval, the diagnostics,
        the policy's History extras and the trust scores."""
        N = self.fl_cfg.num_clients
        with host_readback(self.device):
            # a time_budget break can land between eval boundaries: force
            # a measurement on the final global model
            if time_budget is not None and hist.eval_mask \
                    and not hist.eval_mask[-1]:
                hist.acc[-1] = float(self._eval(global_params))
                hist.eval_mask[-1] = True

            # final diagnostics (paper Fig. 1(b)(c))
            if diagnostics:
                with self._tracer.span("diagnostics"):
                    hist.per_class_acc = to_host(
                        CLF.clf_per_class_accuracy(
                            global_params, self._test_x, self._test_y,
                            self.data.num_classes))
                    n = min(N, self.data.x.shape[0])
                    x = torch.as_tensor(self.data.x[:n],
                                        dtype=torch.float32,
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
        return hist

    # -- telemetry (repro_torch.obs) ----------------------------------------

    def _resolve_telemetry(self, arg):
        """``run(telemetry=...)`` -> ``Telemetry | None``: None defers to
        ``FLConfig.telemetry`` (a bare session at that level), False turns
        it off, a level string builds a bare session, a ``Telemetry`` is
        used as it is."""
        if arg is False:
            return None
        if arg is None:
            lvl = self.fl_cfg.telemetry
            return None if lvl is None else obs.Telemetry(level=lvl)
        if isinstance(arg, str):
            return obs.Telemetry(level=arg)
        return arg

    def _metrics_fn(self, level: str, uses_cache: bool,
                    rows_bound: Optional[int] = None):
        """Memoised metrics function of the active round path: ``(fn,
        needed ctx keys)``, ``(None, ())`` when nothing applies.  The
        availability set says exactly what the path produces, so a
        registered metric with unmet needs is never run.  ``rows_bound``
        is the policy's selection bound on the full scan, where the rows
        are the fleet-sized (N, ...) stack: ``update_norm`` gathers the
        received rows into a (rows_bound, D) block before its kernels."""
        key = (level, self.cohort, self.offload, self._agg_stateful,
               bool(uses_cache), rows_bound)
        if key not in self._metrics_fns:
            avail = {"selected", "distribute", "resume", "online",
                     "received", "fail", "losses", "times", "progress",
                     "stamp", "rnd", "rows", "rows_mask", "global"}
            if self.cohort is not None:
                avail.add("cohort_size")
            if self._agg_stateful:
                avail.add("rule_state")
            if self.offload == "discard" and uses_cache:
                avail.add("stamp_pre_expire")
            static = {"num_clients": self.fl_cfg.num_clients,
                      "cohort_size": self.cohort,
                      "local_steps": self.sim_cfg.local_steps,
                      "staleness_edges": OM.STALENESS_EDGES,
                      "rows_bound": rows_bound,
                      "agg_impl": self.fl_cfg.agg_impl,
                      "pack_layout": AGG.pack_layout(self._template)}
            self._metrics_fns[key] = OM.make_metrics_fn(level, avail,
                                                        static)
        return self._metrics_fns[key]

    def _metrics_hook(self, tel, uses_cache, rows_bound):
        """The round loops' metrics call, or None with telemetry off:
        ``hook(rnd, global_params, caches, rule_state, stamp_pre_expire,
        **cand) -> {column: device value}``.  It runs before the round's
        server step, which writes the cohort caches in place."""
        if tel is None or tel.level is None:
            return None
        fn, keys = self._metrics_fn(tel.level, uses_cache, rows_bound)
        if fn is None:
            return None

        def hook(rnd, global_params, caches, rule_state, stamp_pre_expire,
                 **cand):
            cand.update(progress=caches.progress, stamp=caches.round_stamp,
                        rnd=rnd, rule_state=rule_state,
                        stamp_pre_expire=stamp_pre_expire)
            cand["global"] = global_params
            with self._tracer.span("metrics", round=rnd):
                return fn({k: cand[k] for k in keys})
        return hook

    def _thompson_source(self, thompson_draws):
        """``rnd -> (alpha, beta) -> (N,) draws`` for the round's
        ``RoundObservation.thompson`` (None under ``selection_mode=
        "mean"``): handed-in draws placed on the engine's device, or by
        default Beta samples of a generator there."""
        if self.fl_cfg.selection_mode != "thompson":
            return lambda rnd: None
        device = self.device
        if thompson_draws is None:
            gen = torch.Generator(device=device).manual_seed(
                self.sim_cfg.seed + THOMPSON_SALT)
            sampler = lambda a, b: sample_dependability(  # noqa: E731
                BetaBelief(a, b), gen)
            return lambda rnd: sampler

        def source(rnd):
            def draws(alpha, beta):
                d = thompson_draws(rnd, alpha, beta)
                if isinstance(d, torch.Tensor):
                    return d.to(device=device, dtype=torch.float32)
                return place_per_client(d, device).to(torch.float32)
            return draws
        return source

    # -- debug_checks (repro_torch.analysis.runtime) ------------------------

    def _debug_round_check(self, global_params, losses, idx, rnd):
        """``FLConfig.debug_checks``: the round guard over the post-step
        global model, the losses and the cohort index, read once through
        ``host_readback`` — the sanitiser's one wait a round."""
        from repro_torch.analysis import runtime as RT
        with_idx = idx is not None
        if with_idx not in self._round_guards:
            self._round_guards[with_idx] = RT.make_round_guard(
                self.fl_cfg.num_clients, with_idx=with_idx)
        guard = self._round_guards[with_idx]
        flags = guard(global_params, losses) if idx is None \
            else guard(global_params, losses, idx)
        RT.check_round(flags, guard.messages, rnd, self.device)

    def _debug_rebuild_check(self, policy, tel):
        """``FLConfig.debug_checks`` at run end: no memoised round
        function was rebuilt by a repeat of a run."""
        from repro_torch.analysis import runtime as RT
        if self._rebuild_detector is None:
            self._rebuild_detector = RT.RebuildDetector(self)
        self._rebuild_detector.check(
            (policy.name, policy.uses_cache, policy.waits_for_stragglers,
             None if tel is None else tel.level))

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
            with self._tracer.span("eval_readback", round=rnd):
                acc = float(self._eval(global_params))
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
                     caches, rule_state, explore_uniforms, thompson,
                     n_rounds, time_budget, eval_every, progress, tel):
        """The seed simulator's numpy round loop, draw for draw the
        reference's ``_host_rounds``.  With telemetry on, the round's
        metrics are read back within the round, as the loop reads
        everything else."""
        sim_cfg, fl_cfg = self.sim_cfg, self.fl_cfg
        N = fl_cfg.num_clients
        tracer = self._tracer
        measure = self._metrics_hook(tel, policy.uses_cache,
                                     policy.selection_bound())
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
            if tel is not None:
                tel.maybe_profile(rnd)
            online = fleet.online_mask()
            with tracer.span("plan", round=rnd):
                state, plan = policy.plan(
                    state, RoundObservation(rnd, online, caches,
                                            explore_uniforms(rnd),
                                            thompson=thompson(rnd)))
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
            with tracer.span("trainer", round=rnd):
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
            mx = None
            if measure is not None:
                recv_d = self._put(received)
                mx = measure(
                    rnd, global_params, caches, rule_state, None,
                    selected=self._put(selected),
                    distribute=self._put(distribute),
                    resume=self._put(resume), online=self._put(online),
                    received=recv_d, fail=self._put(fail), losses=losses,
                    times=self._put(times.astype(np.float32)), rows=final,
                    rows_mask=recv_d)
            with tracer.span("server_step", round=rnd):
                out = server_step(
                    global_params, caches, final, cache_p, cached_steps,
                    self._put(selected), self._put(fail),
                    self._put(received), self._put(resume),
                    self._n_samples, extra_w, rnd,
                    *self._step_extra(rule_state))
            if self._agg_stateful:
                global_params, caches, rule_state = out
            else:
                global_params, caches = out

            if self.debug_checks:
                self._debug_round_check(global_params, losses, None, rnd)
            with tracer.span("observe", round=rnd):
                state = policy.observe(
                    state, plan,
                    RoundReport(received=received, fail=fail,
                                losses=to_host(losses), durations=times,
                                duration=duration, rnd=rnd))

            cum_comm, cum_time, acc = self._book_round(
                hist, rnd, n_rounds, eval_every, global_params,
                distribute & online, received, selected, duration,
                cum_comm, cum_time, acc, progress)
            if tel is not None:
                _record_metrics(
                    hist, tel, rnd, bool(hist.eval_mask[-1]), acc,
                    float(duration), cum_comm, cum_time,
                    int(received.sum()), int((distribute & online).sum()),
                    int(selected.sum()),
                    {} if mx is None else
                    {k: v.tolist() for k, v in mx.items()})
        return state, global_params, caches, rule_state

    # -- device dynamics round loop (repro_torch.fleet) ---------------------

    def _dynamics_fns(self, fleet):
        """Memoized device-dynamics artifacts for the configured process:
        ``(process, trainer)`` — the process built on this fleet's
        features on the engine's device, and the dynamics trainer.  (The
        round cut is memoized per straggler trait — ``_round_cut``.)"""
        key = (self.fl_cfg.dynamics, self.fl_cfg.dynamics_params)
        if key not in self._dyn_cache:
            feats = fleet.features(self.device)
            process = make_dynamics(self.fl_cfg.dynamics, self.sim_cfg,
                                    features=feats, device=self.device,
                                    params=self.fl_cfg.dynamics_params)
            trainer = make_trainer(
                self.sim_cfg, self.data, self.device,
                dynamics_features=feats, cohort_size=self.cohort)
            self._dyn_cache[key] = (process, trainer)
        return self._dyn_cache[key]

    def _dyn_consts(self, fleet, uses_cache):
        """Per-run (N,) constants, placed once and reused across runs."""
        N = self.fl_cfg.num_clients
        key = ("cache_every", bool(uses_cache))
        if key not in self._round_consts:
            ce = np.clip(np.round(to_host(C.adaptive_cache_interval(
                2.0, fleet.battery, fleet.stability))), 1, 4
            ).astype(np.int32) if uses_cache else np.full(N, BIG, np.int32)
            self._round_consts[key] = place_per_client(ce, self.device)
        if "ones" not in self._round_consts:
            self._round_consts["ones"] = torch.ones(
                (N,), dtype=torch.float32, device=self.device)
            self._round_consts["full_steps"] = torch.full(
                (N,), self.sim_cfg.local_steps, dtype=torch.int32,
                device=self.device)
        return (self._round_consts[key], self._round_consts["ones"],
                self._round_consts["full_steps"])

    def _from_plan(self, arr, dtype=None):
        """One (N,) plan field on the engine's device.  Tensors (the
        device policy's plans) pass through; a host-side policy's numpy
        arrays cost one upload."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        with self._tracer.span("place_per_client"):
            return place_per_client(np.asarray(arr) if dtype is None
                                    else np.asarray(arr, dtype),
                                    self.device)

    def _round_cut(self, waits_for_stragglers: bool):
        """Memoized device round cut for one straggler trait; with a
        cohort it cuts the (X,) block and scatters the (N,) receive
        mask."""
        key = bool(waits_for_stragglers)
        if key not in self._cut_fns:
            if self.cohort is None:
                self._cut_fns[key] = R.make_round_cut(
                    self.fl_cfg.num_clients, self.sim_cfg.round_deadline,
                    key)
            else:
                self._cut_fns[key] = R.make_round_cut(
                    self.cohort, self.sim_cfg.round_deadline, key,
                    scatter_num_clients=self.fl_cfg.num_clients)
        return self._cut_fns[key]

    def _noise_sources(self, process, explore_uniforms, dynamics_noise):
        """``(explore(rnd), noise(rnd_or_"init"))`` on the engine's device:
        handed-in values are placed there, the defaults drawn there from
        generators seeded from ``sim_cfg.seed``."""
        N, device, seed = self.fl_cfg.num_clients, self.device, \
            self.sim_cfg.seed

        def place(u):
            if isinstance(u, torch.Tensor):
                return u.to(device=device, dtype=torch.float32)
            return place_per_client(u, device).to(torch.float32)

        if explore_uniforms is None:
            gen = torch.Generator(device=device).manual_seed(seed)

            def explore(rnd):
                return torch.rand((N,), generator=gen, device=device)
        else:
            def explore(rnd):
                return place(explore_uniforms(rnd))

        if dynamics_noise is None:
            dgen = torch.Generator(device=device).manual_seed(
                seed + 0x0F1EE7)

            def noise(rnd):
                specs = process.init_noise if rnd == "init" \
                    else process.step_noise
                return draw_noise(specs, N, dgen, device)
        else:
            def noise(rnd):
                return {k: place(v) for k, v in dynamics_noise(rnd).items()}
        return explore, noise

    # -- compact cohort and host-offload round plumbing ---------------------

    def _zero_cohort_block(self):
        """An all-zero (X, ...) cache block, made once, for offload
        policies that never cache: the resident path gathers the
        never-written zero caches, so the trainer's inputs are the same
        and no copy runs."""
        if self._zeros_x is None:
            X = int(self.cohort)
            self._zeros_x = tree_map(
                lambda a: torch.zeros((X,) + tuple(a.shape), dtype=a.dtype,
                                      device=a.device), self._template)
        return self._zeros_x

    def _full_round(self, trainer, cut_fn, server_step, global_params,
                    caches, rule_state, draw, plan, masks, rnd,
                    uses_cache, measure):
        """One full-scan round: trainer, cut and server step over all N
        rows.  Returns ``(step outputs, report, t_cut, capped, counts,
        overflow, metrics, cohort index)``."""
        sel_d, dist_d, res_d, base_steps, cache_every, extra_w = masks
        tracer = self._tracer
        # workload + failure/interruption + masked local training +
        # per-device timing
        with tracer.span("trainer", round=rnd):
            (final, cache_p, cached_steps, losses, _steps, fail, success,
             times) = trainer(global_params, caches, draw, sel_d, dist_d,
                              res_d, base_steps, cache_every)
        # round termination on the device; a capped round comes back as a
        # flag so the ledger bills the exact deadline
        with tracer.span("round_cut", round=rnd):
            t_cut, received, capped, *counts = cut_fn(
                times, plan.quorum, success, draw.online, dist_d, sel_d)
        mx = None if measure is None else measure(
            received=received, fail=fail, losses=losses, times=times,
            rows=final, rows_mask=received)
        with tracer.span("server_step", round=rnd):
            out = server_step(global_params, caches, final, cache_p,
                              cached_steps, sel_d, fail, received, res_d,
                              self._n_samples, extra_w, rnd,
                              *self._step_extra(rule_state))
        report = RoundReport(received=received, fail=fail, losses=losses,
                             durations=times, duration=t_cut, rnd=rnd)
        return out, report, t_cut, capped, counts, None, mx, None

    def _cohort_round(self, trainer, cut_fn, server_step, global_params,
                      caches, rule_state, draw, plan, masks, rnd,
                      uses_cache, measure):
        """One compact-cohort round: the trainer gathers the selected
        rows into (X, ...) blocks and hands back (N,) report views; cut
        and server step run over X rows.  Under offload the stream
        fetches the cohort's cache rows by the index before the trainer
        runs, and the round's write-back is queued after the server
        step.  Returns what ``_full_round`` returns."""
        sel_d, dist_d, res_d, base_steps, cache_every, extra_w = masks
        tracer = self._tracer
        idx = cohort_index(sel_d, self.cohort)
        overflow = cohort_overflow(sel_d, self.cohort)
        cache_x = None
        if self.offload is not None:
            if uses_cache:
                with tracer.span("cache_fetch", round=rnd):
                    cache_x = self._cache_stream.fetch(idx, rnd)
            else:
                cache_x = self._zero_cohort_block()
        with tracer.span("trainer", round=rnd):
            (final, cache_p, cached_steps, _losses_x, _steps_x, fail,
             success, times, losses_n, fail_n, times_n) = trainer(
                global_params, caches, cache_x, idx, draw, sel_d, dist_d,
                res_d, base_steps, cache_every)
        with tracer.span("round_cut", round=rnd):
            t_cut, received_x, received, capped, *counts = cut_fn(
                times, plan.quorum, success, idx, draw.online, dist_d,
                sel_d)
        mx = None if measure is None else measure(
            received=received, fail=fail_n, losses=losses_n, times=times_n,
            rows=final, rows_mask=received_x)
        with tracer.span("server_step", round=rnd):
            if self.offload is None:
                out = server_step(global_params, caches, final, cache_p,
                                  cached_steps, idx, sel_d, fail,
                                  received_x, res_d, self._n_samples,
                                  extra_w, rnd,
                                  *self._step_extra(rule_state))
            else:
                out = server_step(global_params, caches, final,
                                  cached_steps, idx, sel_d, fail,
                                  received_x, res_d, self._n_samples,
                                  extra_w, rnd,
                                  *self._step_extra(rule_state))
        if self.offload is not None:
            write_x, stamp_x = out[2], out[3]
            out = out[:2] + out[4:]
            if uses_cache:
                # the write-back's copies start now; nothing waits for
                # them until the next round's fetch
                with tracer.span("cache_stage", round=rnd):
                    self._cache_stream.stage(idx, write_x, received_x,
                                             cache_p, stamp_x)
        report = RoundReport(received=received, fail=fail_n,
                             losses=losses_n, durations=times_n,
                             duration=t_cut, rnd=rnd)
        return out, report, t_cut, capped, counts, overflow, mx, idx

    def _device_rounds(self, policy, state, fleet, hist, global_params,
                       caches, rule_state, explore_uniforms, dynamics_noise,
                       thompson, n_rounds, time_budget, eval_every,
                       progress, tel):
        """The device round loop, the reference's ``_device_rounds``: the
        process step, the plan, the dynamics trainer, the round cut and
        the server step run on the engine's device with no host value
        between them — over all N rows, or with ``cohort_size`` over the
        round's (X, ...) cohort (``_cohort_round``).  History rows go
        through a ``_RoundLedger``, read back when the pipeline depth, an
        eval-free ``progress`` tick, a ``time_budget`` or the run end asks
        for them; with telemetry on, the round's metric values ride in
        the same row.  FLUDE plans on the device; the host-side baselines
        read back at their own boundary."""
        sim_cfg = self.sim_cfg
        uses_cache = policy.uses_cache
        tracer = self._tracer
        process, trainer = self._dynamics_fns(fleet)
        cache_every, ones_w, full_steps = self._dyn_consts(fleet, uses_cache)
        server_step = self._server_step(uses_cache)
        cut_fn = self._round_cut(policy.waits_for_stragglers)
        round_fn = self._full_round if self.cohort is None \
            else self._cohort_round
        # cohort rows are the compact (X, ...) block already; the full
        # scan gives the policy's selection bound, so update_norm gathers
        # the received rows instead of reading all N
        hook = self._metrics_hook(
            tel, uses_cache,
            None if self.cohort is not None else policy.selection_bound())
        expire_metrics = hook is not None and self.offload == "discard" \
            and uses_cache
        explore, noise = self._noise_sources(process, explore_uniforms,
                                             dynamics_noise)
        ledger = _RoundLedger(hist, sim_cfg.model_mb, sim_cfg.round_deadline,
                              progress, n_rounds, self.device,
                              cohort_info=(policy.name, self.cohort),
                              telemetry=tel, tracer=tracer)
        fstate = process.init_state(noise("init"))
        draw = None
        for rnd in range(n_rounds):
            if time_budget is not None:
                # the budget check needs the wall clock: resolve all
                ledger.resolve()
                if ledger.cum_time >= time_budget:
                    break
            if tel is not None:
                tel.maybe_profile(rnd)
            with tracer.span("dynamics_step", round=rnd):
                fstate, draw = process.step(fstate, noise(rnd))
            stamp_pre_expire = None
            if self.offload == "discard" and uses_cache:
                # the device half of the bound: stale metadata reset
                # before planning reads it, as the store prunes its rows
                # (in place: the metrics keep a copy of the stamps)
                if expire_metrics:
                    stamp_pre_expire = caches.round_stamp.clone()
                with tracer.span("cache_expire", round=rnd):
                    caches = C.expire_caches(
                        caches, rnd, self.fl_cfg.cache_staleness_bound)
            with tracer.span("plan", round=rnd):
                state, plan = policy.plan(
                    state, RoundObservation(rnd, draw.online, caches,
                                            explore(rnd), draw=draw,
                                            thompson=thompson(rnd)))
            self._validate_plan(plan)
            masks = (self._from_plan(plan.selected, bool),
                     self._from_plan(plan.distribute, bool),
                     self._from_plan(plan.resume, bool),
                     full_steps if plan.steps_override is None else
                     self._from_plan(plan.steps_override, np.int32),
                     cache_every,
                     ones_w if plan.agg_weights is None else
                     self._from_plan(plan.agg_weights, np.float32))
            measure = None
            if hook is not None:
                measure = functools.partial(
                    hook, rnd, global_params, caches, rule_state,
                    stamp_pre_expire, selected=masks[0],
                    distribute=masks[1], resume=masks[2],
                    online=draw.online)
            out, report, t_cut, capped, counts, overflow, mx, idx = \
                round_fn(trainer, cut_fn, server_step, global_params,
                         caches, rule_state, draw, plan, masks, rnd,
                         uses_cache, measure)
            if self._agg_stateful:
                global_params, caches, rule_state = out
            else:
                global_params, caches = out
            if self.debug_checks:
                self._debug_round_check(global_params, report.losses, idx,
                                        rnd)
            with tracer.span("observe", round=rnd):
                state = policy.observe(state, plan, report)

            evaluated = rnd % eval_every == 0 or rnd == n_rounds - 1
            acc = None
            if evaluated:
                with tracer.span("eval", round=rnd):
                    acc = self._eval(global_params)
            ledger.push(rnd, evaluated, t_cut, capped, *counts, acc=acc,
                        overflow=overflow, metrics=mx)
            if progress and rnd % 10 == 0:
                ledger.resolve()        # live ticks resolve on schedule
            else:
                ledger.resolve(keep=self.pipeline_depth - 1)
        ledger.resolve()
        if self._cache_stream is not None:
            # the last round's write-back into the store, so it holds the
            # run's final caches
            with tracer.span("cache_flush"):
                self._cache_stream.drain(n_rounds)
        self._last_fleet_state = fstate
        self._last_draw = draw
        return state, global_params, caches, rule_state
