"""Host-offloaded C3 cache store (``FLConfig.cache_offload``), the port of
``repro.core.cache_store``.

Under ``cache_offload="host"`` the fleet's (N, D) cache params leave the
card: it keeps the (N,) cache metadata (progress, round stamp — all that
planning reads) and the round's (X, D) cohort block, and this module owns
the host side of the round trip:

* :class:`HostCacheStore` — a sparse store of one packed (D,) row per
  client that holds a cached model, so host memory follows the live
  slots, not the fleet.  A never-written, cleared or sentinel row reads
  as zeros, the empty slot the resident gather reads for rows whose
  metadata says "no cache".
* :class:`CohortCacheStream` — the double-buffered copies around the
  store, on a side CUDA stream with events in both directions.  Two
  pinned (X, D) staging buffers, one each way: the fetch gathers the
  cohort's rows into one and copies it to the card; the write-back
  copies the trainer's cache block into the other right after the server
  step is queued, and the next round's fetch drains it into the store.
  The host waits twice a round, both through ``repro_torch.device.
  host_readback``: for the previous round's write-back and for the cohort
  index it must read to gather.  Nothing else in a round waits for the
  card; ``TransferStats.sync_copies`` stays 0.

``cache_offload="discard"`` also drops rows whose stamp is more than
``cache_staleness_bound`` rounds old; the device half,
``repro_torch.core.caching.expire_caches``, resets their metadata with the
same predicate before each plan, so the planner never resumes a pruned
row.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import host_readback
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass
class TransferStats:
    """Counters of one offload stream's host transfers.

    ``*_async`` count copies queued without waiting (one per payload);
    ``pre_issued_reads`` counts host reads of a payload whose copy was
    queued earlier (the drain, and the cohort index's read);
    ``sync_copies`` counts copies that wait for the card when queued —
    the stream makes none."""
    h2d_async: int = 0
    d2h_async: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    pre_issued_reads: int = 0
    sync_copies: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class HostCacheStore:
    """Sparse host store of per-client C3 cache rows.

    Each entry is one client's cached model packed into a (D,) numpy row
    (the template's leaves in tree order; they must share one dtype), an
    owned copy, with the round stamp it was written with.
    ``num_clients`` is the sentinel id: gathers read it, and any id with
    no row, as zeros."""

    def __init__(self, template_params, num_clients: int,
                 staleness_bound: Optional[int] = None):
        leaves = tree_leaves(template_params)
        dtypes = {torch.empty(0, dtype=l.dtype).numpy().dtype
                  if isinstance(l, torch.Tensor) else np.asarray(l).dtype
                  for l in leaves}
        if len(dtypes) != 1:
            raise ValueError(f"HostCacheStore packs a row of one dtype, the "
                             f"template has {sorted(map(str, dtypes))}")
        self.dtype = dtypes.pop()
        self._template = template_params
        self._shapes = [tuple(l.shape) for l in leaves]
        self._sizes = [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
        self.dim = sum(self._sizes)
        self.num_clients = int(num_clients)
        self.staleness_bound = None if staleness_bound is None \
            else int(staleness_bound)
        self.row_bytes = self.dim * self.dtype.itemsize
        self._rows: Dict[int, np.ndarray] = {}
        self._stamps: Dict[int, int] = {}
        self.pruned = 0             # rows dropped by the staleness bound

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def nbytes(self) -> int:
        """Bytes of the stored rows."""
        return len(self._rows) * self.row_bytes

    def stamp_of(self, client_id: int) -> Optional[int]:
        return self._stamps.get(int(client_id))

    def clear(self) -> None:
        self._rows.clear()
        self._stamps.clear()
        self.pruned = 0

    # -- packing --------------------------------------------------------------

    def unpack(self, flat):
        """The template's nested dict of (X, ...) views of an (X, D)
        array or tensor."""
        x, out, off = flat.shape[0], [], 0
        for shape, size in zip(self._shapes, self._sizes):
            out.append(flat[:, off:off + size].reshape((x,) + shape))
            off += size
        return tree_unflatten(self._template, out)

    def pack(self, block) -> np.ndarray:
        """An (X, D) numpy array of a nested dict of (X, ...) arrays (an
        (X, D) array passes through)."""
        if not isinstance(block, dict):
            return np.asarray(block)
        leaves = [np.asarray(l) for l in tree_leaves(block)]
        return np.concatenate([l.reshape(l.shape[0], -1) for l in leaves],
                              axis=1)

    # -- fetch / apply --------------------------------------------------------

    def gather(self, idx, out: Optional[np.ndarray] = None):
        """The rows at ``idx`` as the template's nested dict of (X, ...)
        arrays, views of ``out`` (an (X, D) array, allocated when not
        given), which the rows are written into in place.  Sentinel ids
        and ids with no row read as zeros."""
        idx = np.asarray(idx)
        x = idx.shape[0]
        if out is None:
            out = np.empty((x, self.dim), self.dtype)
        rows = self._rows
        for k in range(x):
            row = rows.get(int(idx[k]))
            if row is None:
                out[k] = 0
            else:
                out[k] = row
        return self.unpack(out)

    def apply(self, idx, write, clear, stamps, block,
              current_round: int) -> None:
        """One round's cache bookkeeping.  ``idx`` / ``write`` / ``clear``
        / ``stamps`` are (X,) host arrays and ``block`` the trainer's
        (X, ...) cache params (a nested dict, or packed (X, D)).  Rows are
        written where ``write`` (owned copies) and deleted where
        ``clear`` (a received upload empties the slot); the two are
        disjoint.  Under a staleness bound, rows staler than it at
        ``current_round`` are pruned, as ``expire_caches`` resets their
        metadata."""
        idx = np.asarray(idx)
        write = np.asarray(write)
        clear = np.asarray(clear)
        stamps = np.asarray(stamps)
        flat = self.pack(block)
        n = self.num_clients
        for k in range(idx.shape[0]):
            cid = int(idx[k])
            if cid >= n:
                continue
            if write[k]:
                self._rows[cid] = np.array(flat[k], self.dtype)
                self._stamps[cid] = int(stamps[k])
            elif clear[k]:
                self._rows.pop(cid, None)
                self._stamps.pop(cid, None)
        if self.staleness_bound is not None:
            self.prune(current_round)

    def prune(self, current_round: int) -> None:
        """Drop rows staler than the bound at ``current_round``: the
        predicate of ``expire_caches``, ``current_round - stamp >
        bound``."""
        bound = self.staleness_bound
        if bound is None:
            return
        dead = [cid for cid, st in self._stamps.items()
                if int(current_round) - st > bound]
        for cid in dead:
            self._rows.pop(cid, None)
            self._stamps.pop(cid, None)
        self.pruned += len(dead)


class CohortCacheStream:
    """Double-buffered card ↔ host copies of the cohort's cache slots.

    The engine calls it twice a round:

    * ``fetch(idx, rnd)`` once the round's cohort index is queued: queues
      the index's copy to the host, drains the previous round's
      write-back into the store, reads the index, gathers the cohort's
      rows into the pinned fetch buffer and queues its copy to a fresh
      (X, D) block on the card, which the compute stream waits for.
    * ``stage(idx, write, clear, block, stamps)`` right after the server
      step is queued: queues the copies of the round's write-back into
      the pinned write-back buffers behind an event; nothing waits until
      the next ``fetch`` (or the run end's ``drain``) drains them.

    Every copy runs on one side stream, in the order queued, so once the
    host has waited for round k's index, every earlier copy is done:
    round k - 1's fetch buffer and write-back buffers are free.

    On the CPU the copies are plain copies and nothing waits."""

    def __init__(self, store: HostCacheStore, cohort_size: int, device,
                 stats: Optional[TransferStats] = None):
        self.store = store
        self.cohort_size = int(cohort_size)
        self.device = torch.device(device)
        self.stats = stats if stats is not None else TransferStats()
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._buffers = None
        # (event,) behind a queued write-back's copies (None on the CPU)
        self._pending: Optional[tuple] = None

    # -- helpers ---------------------------------------------------------------

    def _host(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=self._cuda)

    def _bufs(self):
        """The pinned host buffers, allocated on first use: the index,
        the fetch block, the write-back block and its (4, X) metadata."""
        if self._buffers is None:
            x, d = self.cohort_size, self.store.dim
            dtype = getattr(torch, self.store.dtype.name)
            self._buffers = dict(
                idx=self._host((x,), torch.int64),
                fetch=self._host((x, d), dtype),
                back=self._host((x, d), dtype),
                meta=self._host((4, x), torch.int32))
        return self._buffers

    def _on_side(self, *tensors):
        """Context of copies on the side stream, queued behind the work
        already on the compute stream; ``tensors`` (card memory the side
        stream touches) are marked used by it, so the allocator does not
        hand them out again before its copies are done."""
        if not self._cuda:
            return contextlib.nullcontext()
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        for t in tensors:
            t.record_stream(self._side)
        return torch.cuda.stream(self._side)

    def _event(self):
        """An event behind the side stream's queued copies (None on the
        CPU)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._side)
        return ev

    def _wait(self, event):
        """One of the stream's two deliberate waits a round."""
        if event is not None:
            with host_readback(self.device):
                event.synchronize()
        self.stats.pre_issued_reads += 1

    # -- the protocol ----------------------------------------------------------

    def fetch(self, idx: torch.Tensor, rnd: int):
        """The cohort's cache rows as a nested dict of (X, ...) views of
        an (X, D) block on the engine's device, its copy queued."""
        bufs = self._bufs()
        block = torch.empty(bufs["fetch"].shape, dtype=bufs["fetch"].dtype,
                            device=self.device)
        with self._on_side(idx, block):
            bufs["idx"].copy_(idx, non_blocking=True)
            idx_ready = self._event()
        self.stats.d2h_async += 1
        self.stats.d2h_bytes += bufs["idx"].nbytes
        self.drain(rnd)
        self._wait(idx_ready)
        self.store.gather(bufs["idx"].numpy(), out=bufs["fetch"].numpy())
        with self._on_side():
            block.copy_(bufs["fetch"], non_blocking=True)
            block_ready = self._event()
        if block_ready is not None:
            torch.cuda.current_stream(self.device).wait_event(block_ready)
        self.stats.h2d_async += 1
        self.stats.h2d_bytes += bufs["fetch"].nbytes
        return self.store.unpack(block)

    def stage(self, idx, write, clear, block, stamps) -> None:
        """Queue one round's write-back; its copies start behind the
        server step."""
        self.drain()                   # at most one round in flight
        bufs = self._bufs()
        x = self.cohort_size
        flat = torch.cat([l.reshape(x, -1).to(bufs["back"].dtype)
                          for l in tree_leaves(block)], dim=1)
        meta = torch.stack([idx.to(torch.int32), write.to(torch.int32),
                            clear.to(torch.int32), stamps.to(torch.int32)])
        with self._on_side(flat, meta):
            bufs["back"].copy_(flat, non_blocking=True)
            bufs["meta"].copy_(meta, non_blocking=True)
            self._pending = (self._event(),)
        self.stats.d2h_async += 1
        self.stats.d2h_bytes += bufs["back"].nbytes + bufs["meta"].nbytes

    def drain(self, rnd: Optional[int] = None) -> None:
        """Apply the queued write-back to the store (waits for its
        copies)."""
        if self._pending is None:
            return
        (event,), self._pending = self._pending, None
        self._wait(event)
        bufs = self._bufs()
        meta = bufs["meta"].numpy()
        self.store.apply(meta[0], meta[1].astype(bool), meta[2].astype(bool),
                         meta[3], bufs["back"].numpy(),
                         0 if rnd is None else int(rnd))

    def reset(self) -> None:
        """Drop a queued write-back and empty the store (a new run)."""
        self._pending = None
        self.store.clear()
