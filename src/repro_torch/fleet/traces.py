"""Trace replay: recorded availability matrices + a synthetic generator
(``repro.fleet.traces``).

``TraceProcess`` replays an (N, T) boolean availability matrix held on
the engine's device, indexed by the round clock and wrapping at T.
``synthesize_trace`` is a numpy copy of the reference's generator, draw
for draw, so a seed gives the same matrix in both packages:

* ``diurnal``            — per-device sinusoidal availability with a few
  timezone clusters (phase groups);
* ``flash-crowd``        — a low-availability baseline punctuated by
  bursts where a large random cohort comes online at once;
* ``correlated-dropout`` — regional outage events that knock a whole
  cluster offline for several consecutive rounds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.fleet.api import (DynamicsProcess, FleetState,
                                   register_dynamics)

TRACE_PATTERNS = ("diurnal", "flash-crowd", "correlated-dropout")


def synthesize_trace(num_clients: int, horizon: int,
                     pattern: str = "diurnal", seed: int = 0,
                     online_rate: Optional[np.ndarray] = None,
                     period: int = 24, amp: float = 0.4,
                     n_clusters: int = 4, event_rate: float = 0.05,
                     outage_len: int = 3, burst_frac: float = 0.8,
                     base_rate: float = 0.15) -> np.ndarray:
    """Generate an (N, T) boolean availability matrix.

    ``online_rate`` (per-device long-run target, (N,)) anchors the
    diurnal/correlated-dropout baselines; defaults to U[0.2, 0.8].
    """
    rng = np.random.RandomState(seed)
    N, T = num_clients, horizon
    if online_rate is None:
        online_rate = rng.uniform(0.2, 0.8, N)
    r = np.clip(np.asarray(online_rate, np.float64), 0.02, 0.98)
    cluster = rng.randint(0, max(n_clusters, 1), N)
    t = np.arange(T)

    if pattern == "diurnal":
        # timezone clusters: one phase per cluster, availability follows
        # a clipped sinusoid around each device's base rate
        phases = rng.uniform(0, period, max(n_clusters, 1))[cluster]
        p = r[:, None] + amp * np.cos(
            2 * np.pi * (t[None, :] + phases[:, None]) / period)
        return rng.rand(N, T) < np.clip(p, 0.02, 0.98)

    if pattern == "flash-crowd":
        # sparse baseline; every ``period`` rounds a burst pulls a large
        # random cohort online for a couple of rounds
        p = np.full((N, T), base_rate)
        for t0 in range(0, T, period):
            crowd = rng.rand(N) < burst_frac
            p[crowd, t0:t0 + max(period // 8, 2)] = 0.95
        return rng.rand(N, T) < p

    if pattern == "correlated-dropout":
        # independent baseline + regional outages: an event takes one
        # whole cluster offline for ``outage_len`` consecutive rounds
        online = rng.rand(N, T) < r[:, None]
        for t0 in range(T):
            if rng.rand() < event_rate:
                hit = cluster == rng.randint(0, max(n_clusters, 1))
                online[hit, t0:t0 + outage_len] = False
        return online

    raise ValueError(f"unknown trace pattern {pattern!r}; "
                     f"available: {', '.join(TRACE_PATTERNS)}")


@register_dynamics("trace")
class TraceProcess(DynamicsProcess):
    """Replay an (N, T) availability matrix, wrapping at T.

    Construct with an explicit ``trace=`` matrix (recorded data) or let
    it synthesize one via ``pattern``/``horizon``/``trace_seed``.
    Failure/interruption variates stay stochastic (exposure-scaled from
    ``undep``); availability is the replay.  The round's column is read
    with ``index_select`` on the device clock, so the step never reads a
    value back to the host.

    Reference keys: the step's key goes straight to the base draw."""

    def __init__(self, sim_cfg, features=None, fleet=None, device="cpu",
                 trace: Optional[np.ndarray] = None,
                 pattern: str = "diurnal", horizon: float = 96,
                 trace_seed: float = 0, **params):
        super().__init__(sim_cfg, features=features, fleet=fleet,
                         device=device, pattern=pattern, horizon=horizon,
                         trace_seed=trace_seed, **params)
        if trace is None:
            trace = synthesize_trace(
                self.num_clients, int(horizon), pattern=pattern,
                seed=int(trace_seed),
                online_rate=self.features.online_rate.cpu().numpy(),
                **{k: v for k, v in params.items()
                   if k in ("period", "amp", "n_clusters", "event_rate",
                            "outage_len", "burst_frac", "base_rate")})
        trace = np.asarray(trace, bool)
        if trace.ndim != 2 or trace.shape[0] != self.num_clients:
            raise ValueError(f"trace must be (num_clients, T), got "
                             f"{trace.shape} for {self.num_clients} clients")
        from repro_torch.fl.simulator import place_per_client
        # one-time placement of the whole (N, T) matrix
        self.trace = place_per_client(trace, self.device)
        self.horizon = trace.shape[1]

    def step(self, state, noise):
        col = torch.remainder(state.t, self.horizon).reshape(1).long()
        online = torch.index_select(self.trace, 1, col)[:, 0]
        return FleetState(t=state.t + 1, slot=state.slot), \
            self._base_draw(noise, online)
