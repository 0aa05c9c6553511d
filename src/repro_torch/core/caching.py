"""C3 — local model caching (paper §4.2).

Each device keeps a *rolling single-slot* cache of its latest local training
state (model params, progress fraction, round stamp).  When an interrupted
device rejoins, it resumes from the cache unless the server's staleness-aware
distributor (C4) overrides it with a fresh global model.

The fleet's caches are a dict of stacked (N, ...) tensors, so cache update
and resume are ``torch.where`` over the client axis; those functions
return new tensors and leave their inputs as they were, as in the
reference.

Compact cohorts gather the cohort's (X, ...) rows and scatter them back.
The reference's ``take(mode="fill")`` and ``.at[].set(mode="drop")`` with
the sentinel index N have no torch counterpart, so the port gathers with
a clamped index and a ``torch.where`` on ``idx < N`` (:func:`take_rows`),
and scatters in place into buffers allocated with one spare row N behind
their (N, ...) view (:func:`spare_rows`): sentinel and masked-off writes
land there.  The real targets of one scatter are distinct cohort ids, so
no two writes race on a client's row.  Nothing reads a value back and
nothing allocates O(N·D) per round.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class ClientCaches(NamedTuple):
    params: Any                 # dict of (N, ...) tensors — cached local state
    progress: torch.Tensor      # (N,) float32 in [0,1] — fraction completed
    round_stamp: torch.Tensor   # (N,) int32 — round when cached (-1 = empty)


def _int32(v, device) -> torch.Tensor:
    """``v`` as an int32 tensor on ``device``; a python number is filled
    there (a host copy would wait for the card)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.full((), v, dtype=torch.int32, device=device)


def _rows(mask, like):
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def spare_rows(num_rows: int, row_shape=(), fill=0, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """(num_rows, ...) view of a ``fill``-ed (num_rows + 1, ...) buffer:
    row ``num_rows`` is spare, the target of the sentinel and masked-off
    writes of :func:`scatter_rows`."""
    return torch.full((num_rows + 1,) + tuple(row_shape), fill,
                      dtype=dtype, device=device)[:num_rows]


def _spare(view: torch.Tensor) -> torch.Tensor:
    """The (N + 1, ...) buffer behind a :func:`spare_rows` view."""
    n = view.shape[0]
    if not view.is_contiguous() or view.untyped_storage().nbytes() < \
            (view.storage_offset() + (n + 1) * view.stride(0)) \
            * view.element_size():
        raise ValueError(
            f"scatter target of shape {tuple(view.shape)} has no spare "
            f"row behind it: allocate it with spare_rows")
    return view.as_strided((n + 1,) + tuple(view.shape[1:]), view.stride(),
                           view.storage_offset())


def take_rows(a: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``a[idx]`` along dim 0, rows at out-of-range ``idx`` (the
    sentinel N) filled with ``fill`` — the reference's
    ``jnp.take(a, idx, axis=0, mode="fill", fill_value=fill)``."""
    n = a.shape[0]
    rows = a.index_select(0, idx.clamp_max(n - 1))
    valid = (idx < n).reshape((-1,) + (1,) * (a.ndim - 1))
    return torch.where(valid, rows, fill)


def scatter_rows(view: torch.Tensor, target: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``view[target] = values`` in place, rows at target N (the spare
    row) dropped — the reference's ``.at[target].set(mode="drop")`` on a
    :func:`spare_rows` view.  Returns ``view``."""
    _spare(view).index_copy_(0, target.to(torch.int64),
                             values.to(view.dtype))
    return view


def init_caches(template_params, num_clients: int,
                device=None) -> ClientCaches:
    """Empty caches: zero params, progress 0, stamp -1, each (N, ...) a
    :func:`spare_rows` view, so the cohort scatters write them in place.
    ``device`` is needed only for a metadata-only (``{}``) template."""
    stacked = tree_map(
        lambda a: spare_rows(num_clients, a.shape, 0, a.dtype, a.device),
        template_params)
    if device is None:
        device = tree_leaves(template_params)[0].device
    return ClientCaches(
        stacked,
        spare_rows(num_clients, (), 0.0, torch.float32, device),
        spare_rows(num_clients, (), -1, torch.int32, device))


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


# ---------------------------------------------------------------------------
# Compact cohorts: gather (N,) slots into (X,) blocks and scatter back
# ---------------------------------------------------------------------------
#
# ``idx`` is the ascending (X,) cohort index padded with the sentinel N
# (``repro_torch.fl.api.cohort_index``).  Gathers read sentinel rows as
# empty slots; scatters point unwritten rows at the spare row N, so a
# gather → update → scatter round trip equals the full-fleet
# ``torch.where`` update exactly.  The scatters and the expiry write the
# caches in place and return them.

def gather_caches(caches: ClientCaches, idx: torch.Tensor) -> ClientCaches:
    """(X, ...) copy of the cache slots at ``idx``; sentinel rows read as
    empty: zero params, zero progress, stamp -1."""
    return ClientCaches(
        tree_map(lambda a: take_rows(a, idx, 0), caches.params),
        take_rows(caches.progress, idx, 0.0),
        take_rows(caches.round_stamp, idx, -1))


def scatter_write_cache(caches: ClientCaches, idx: torch.Tensor,
                        mask: torch.Tensor, new_params,
                        progress: torch.Tensor, rnd) -> ClientCaches:
    """:func:`write_cache` on the cohort rows ``idx``, in place.

    ``mask`` / ``new_params`` / ``progress`` / ``rnd`` are (X,)-leading
    (``rnd`` may also be 0-d).  Masked-off rows go to the spare row, so
    every unwritten slot keeps its value — equal to the full-fleet
    update when the full write mask is zero outside the cohort (writes
    need selection)."""
    n = caches.progress.shape[0]
    target = torch.where(mask, idx, n)
    rnd = _int32(rnd, caches.round_stamp.device)
    tree_map(lambda old, new: scatter_rows(old, target, new),
             caches.params, new_params)
    scatter_rows(caches.progress, target, progress)
    scatter_rows(caches.round_stamp, target,
                 rnd.expand(idx.shape).contiguous())
    return caches


def scatter_clear_cache(caches: ClientCaches, idx: torch.Tensor,
                        mask: torch.Tensor) -> ClientCaches:
    """:func:`clear_cache` on the cohort rows ``idx``, in place (params
    stay, metadata resets)."""
    n = caches.progress.shape[0]
    target = torch.where(mask, idx, n)
    scatter_rows(caches.progress, target,
                 torch.zeros(idx.shape, dtype=torch.float32,
                             device=idx.device))
    scatter_rows(caches.round_stamp, target,
                 torch.full(idx.shape, -1, dtype=torch.int32,
                            device=idx.device))
    return caches


def expire_caches(caches: ClientCaches, current_round,
                  staleness_bound: int) -> ClientCaches:
    """Drop cache slots staler than ``staleness_bound`` rounds, in place:
    the device half of ``FLConfig.cache_offload="discard"``.  Metadata of
    rows whose stamp is more than ``staleness_bound`` rounds old resets
    to the empty slot before planning reads it, so the planner never
    resumes a row the host store has pruned; params stay."""
    rnd = _int32(current_round, caches.round_stamp.device)
    stale = (rnd - caches.round_stamp) > staleness_bound
    caches.progress.masked_fill_(stale, 0.0)
    caches.round_stamp.masked_fill_(stale, -1)
    return caches


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
