"""Fleet simulator: device undependability, online dynamics, timing model.

A numpy copy of ``repro.fl.simulator`` (``SimConfig`` and ``Fleet``), draw
for draw: the per-round draw order ``online_mask → failure_draw →
failure_step`` is the reference's, so a seed gives the same fleet and the
same rounds in both packages.  Mirrors the paper's setup (§5.2): three
dependability groups with normal-distributed undependability rates,
online/offline state re-drawn every round with a per-device online rate in
[0.2, 0.8], three compute tiers and WiFi bandwidths of 1–30 Mb/s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def place_per_client(arr, device) -> torch.Tensor:
    """Place one host per-client array on ``device`` — a copy.  On a card
    the copy goes through pinned memory and does not block the host, so a
    placement never waits for the work queued before it."""
    t = torch.from_numpy(np.array(arr, order="C", copy=True))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    num_clients: int = 100
    rounds: int = 100
    local_steps: int = 8
    batch_size: int = 32
    lr: float = 0.05
    # classifier capacity (repro_torch.fl.classifier MLP)
    model_hidden: int = 128
    model_depth: int = 2
    # undependability (three groups, paper §5.2)
    undep_means: tuple = (0.2, 0.4, 0.6)
    undep_std: float = 0.2           # sqrt(0.04)
    # online dynamics
    online_low: float = 0.2
    online_high: float = 0.8
    state_interval: float = 600.0    # 10 min
    # compute/communication heterogeneity
    steps_per_sec: tuple = (2.0, 1.0, 0.5)   # three device tiers
    bandwidth_mbps: tuple = (1.0, 30.0)      # WiFi range (megabits/s)
    model_mb: float = 20.0                   # transmitted model size
    round_deadline: float = 600.0            # T (seconds)
    group_mode: str = "random"               # random | class (dependability
                                             # correlated with data classes —
                                             # the paper's "unique and
                                             # critical data" scenario §2.2)
    seed: int = 0


class Fleet:
    """numpy-side device population; per-round draws are methods."""

    def __init__(self, cfg: SimConfig,
                 undep_means: Optional[tuple] = None):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        N = cfg.num_clients
        means = undep_means if undep_means is not None else cfg.undep_means
        if cfg.group_mode == "class":
            # align groups with the data partitioner's anchor classes
            # (client i anchors class i % 10) so whole classes live on
            # less-dependable devices — the paper's bias scenario
            group = (np.arange(N) % 10) % len(means)
        else:
            group = rng.randint(0, len(means), N)
        self.undep = np.clip(
            rng.randn(N) * cfg.undep_std + np.asarray(means)[group],
            0.02, 0.98)
        self.online_rate = rng.uniform(cfg.online_low, cfg.online_high, N)
        tier = rng.randint(0, len(cfg.steps_per_sec), N)
        self.steps_per_sec = np.asarray(cfg.steps_per_sec)[tier] \
            * rng.uniform(0.8, 1.2, N)
        lo, hi = cfg.bandwidth_mbps
        self.bandwidth = rng.uniform(lo, hi, N)          # megabits/s
        self.battery = rng.uniform(0.2, 1.0, N)
        self.stability = rng.uniform(0.3, 1.0, N)
        self._rng = rng

    def features(self, device):
        """This population as ``repro_torch.fleet.FleetFeatures`` on
        ``device`` — the one-time host→device hand-off every dynamics
        process draws its static per-device parameters from."""
        from repro_torch.fleet import FleetFeatures
        return FleetFeatures.from_fleet(self, device)

    # -- per-round draws ----------------------------------------------------
    def online_mask(self) -> np.ndarray:
        return self._rng.rand(self.cfg.num_clients) < self.online_rate

    def failure_draw(self, work_frac: np.ndarray) -> np.ndarray:
        """Bernoulli failure with exposure scaling: a device doing a
        fraction ``work_frac`` of a full local pass fails with probability
        1 - (1 - p)^work_frac (resumed devices are safer — §4.2)."""
        p = 1.0 - np.power(1.0 - self.undep, np.clip(work_frac, 0.0, 1.0))
        return self._rng.rand(self.cfg.num_clients) < p

    def failure_step(self, steps: np.ndarray) -> np.ndarray:
        """Uniform interruption point within each device's planned steps."""
        u = self._rng.rand(self.cfg.num_clients)
        return np.floor(u * np.maximum(steps, 1)).astype(np.int32)

    # -- timing model --------------------------------------------------------
    def comm_seconds(self) -> np.ndarray:
        """One model transmission (download or upload) per device."""
        return self.cfg.model_mb * 8.0 / self.bandwidth

    def train_seconds(self, steps: np.ndarray) -> np.ndarray:
        return steps / self.steps_per_sec

    def round_times(self, steps: np.ndarray, downloaded: np.ndarray,
                    completed_steps: np.ndarray,
                    success: np.ndarray) -> np.ndarray:
        """Wall-clock finish time per device (np.inf if it never uploads)."""
        t = np.where(downloaded, self.comm_seconds(), 0.0)
        t = t + self.train_seconds(completed_steps)
        t = t + np.where(success, self.comm_seconds(), 0.0)
        return np.where(success, t, np.inf)
