"""C3 — local model caching (paper §4.2).

Each device keeps a *rolling single-slot* cache of its latest local training
state (model params, progress fraction, round stamp).  When an interrupted
device rejoins, it resumes from the cache unless the server's staleness-aware
distributor (C4) overrides it with a fresh global model.

The fleet's caches are a dict of stacked (N, ...) tensors, so cache update
and resume are ``torch.where`` over the client axis.  The functions return
new tensors and leave their inputs as they were, as in the reference.
Gather, scatter and expiry belong to ROADMAP Queue A #10 and #12.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class ClientCaches(NamedTuple):
    params: Any                 # dict of (N, ...) tensors — cached local state
    progress: torch.Tensor      # (N,) float32 in [0,1] — fraction completed
    round_stamp: torch.Tensor   # (N,) int32 — round when cached (-1 = empty)


def _rows(mask, like):
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def init_caches(template_params, num_clients: int) -> ClientCaches:
    stacked = tree_map(
        lambda a: torch.zeros((num_clients,) + tuple(a.shape),
                              dtype=a.dtype, device=a.device),
        template_params)
    device = tree_leaves(template_params)[0].device
    return ClientCaches(
        stacked,
        torch.zeros((num_clients,), dtype=torch.float32, device=device),
        torch.full((num_clients,), -1, dtype=torch.int32, device=device))


def reset_caches(caches: ClientCaches) -> ClientCaches:
    """Value-identical to :func:`init_caches`, in place: the zero/-1 fills
    reuse the existing (N, ...) buffers of a finished run instead of
    allocating a new cache pytree."""
    tree_map(lambda a: a.zero_(), caches.params)
    caches.progress.zero_()
    caches.round_stamp.fill_(-1)
    return caches


def write_cache(caches: ClientCaches, mask: torch.Tensor, new_params,
                progress: torch.Tensor, rnd) -> ClientCaches:
    """Rolling update: overwrite the slot for masked clients (latest only).

    new_params leaves are (N, ...) stacked local states."""
    def upd(old, new):
        return torch.where(_rows(mask, old), new.to(old.dtype), old)

    rnd = torch.as_tensor(rnd, dtype=torch.int32,
                          device=caches.round_stamp.device)
    return ClientCaches(
        tree_map(upd, caches.params, new_params),
        torch.where(mask, progress, caches.progress),
        torch.where(mask, rnd, caches.round_stamp))


def clear_cache(caches: ClientCaches, mask: torch.Tensor) -> ClientCaches:
    """After a successful upload the local cache slot is invalidated."""
    return ClientCaches(
        caches.params,
        torch.where(mask, 0.0, caches.progress),
        torch.where(mask, -1, caches.round_stamp))


def staleness(caches: ClientCaches, current_round) -> torch.Tensor:
    """Rounds elapsed since the cache was written (∞-ish if empty)."""
    empty = caches.round_stamp < 0
    s = torch.as_tensor(current_round, dtype=torch.int32,
                        device=caches.round_stamp.device) \
        - caches.round_stamp
    return torch.where(empty, 1 << 20, s).to(torch.float32)


def has_cache(caches: ClientCaches) -> torch.Tensor:
    return caches.round_stamp >= 0


def resume_params(caches: ClientCaches, global_params, use_cache_mask):
    """Per-client starting state: cached params where resuming, else the
    fresh global model (broadcast).  Leaves: (N, ...)."""
    def pick(cached, g):
        return torch.where(_rows(use_cache_mask, cached), cached,
                           g[None].to(cached.dtype))

    return tree_map(pick, caches.params, global_params)


def adaptive_cache_interval(base_interval, battery, stability):
    """§4.2 "adjusting caching frequency": lower battery / flakier network
    ⇒ cache more often (smaller interval); stable+charged ⇒ less often.

    battery, stability ∈ [0, 1] (numpy or tensors).  Returns per-device
    seconds as float32, clamped to [base/2, 5·base] — float32 like the
    reference, whose host loop rounds this to whole steps."""
    scale = torch.clamp(torch.as_tensor(2.0 * battery * stability,
                                        dtype=torch.float32), 0.5, 5.0)
    return base_interval * scale
