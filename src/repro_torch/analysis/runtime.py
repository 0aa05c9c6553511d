"""``FLConfig.debug_checks`` runtime sanitisers.

Two guards, both off by default (they wait for the card once a round,
which the production round path never does):

* :func:`make_round_guard` — one device vector of flags the engine builds
  after each server step: every global-model leaf finite, every
  per-client loss finite, the cohort index within [0, N].
  :func:`check_round` reads it through ``host_readback`` and raises
  :class:`RoundCheckError` with the round and the first failed check, so
  a NaN stops the run where it appeared instead of running on through
  the trajectory.
* :class:`RebuildDetector` — the counterpart of the reference's
  recompilation detector: it snapshots the sizes of the engine's memo
  caches (trainer, dynamics and round-cut functions, server steps,
  metrics functions, the loaded kernel libraries) and raises if a repeat
  of a run grows any of them — a round function rebuilt because some
  round-path input changed its shape, dtype or placement between runs.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

from repro_torch.device import host_readback
from repro_torch.kernels import _build
from repro_torch.tree import tree_leaves


class RoundCheckError(RuntimeError):
    """A ``debug_checks`` round guard fired."""


def make_round_guard(num_clients: int, with_idx: bool):
    """The round guard: ``guard(global_params, losses[, idx])`` returns
    an on-device bool vector, one flag a check (True = holds), whose
    messages are ``guard.messages``, built from the model on its first
    call.  The cohort index is checked against ``[0, num_clients]``: the
    pad sentinel equals ``num_clients`` by the ``cohort_index``
    contract, anything else is out of range."""
    messages: List[str] = []

    def guard(global_params, losses, idx=None):
        leaves = tree_leaves(global_params)
        if not messages:
            messages.extend(
                f"non-finite value in global-model leaf #{i} after the "
                f"server step" for i in range(len(leaves)))
            messages.append("non-finite per-client loss")
            if with_idx:
                messages.append("cohort index out of bounds (expected "
                                "[0, N] with N as the pad sentinel)")
        flags = [torch.isfinite(leaf).all() for leaf in leaves]
        flags.append(torch.isfinite(losses).all())
        if with_idx:
            flags.append(((idx >= 0) & (idx <= num_clients)).all())
        return torch.stack(flags)

    guard.messages = messages
    return guard


def check_round(flags: torch.Tensor, messages: List[str], rnd: int,
                device) -> None:
    """Read the guard's flags back (the sanitiser's one wait a round,
    through ``host_readback``) and raise :class:`RoundCheckError` naming
    the round and the first failed check."""
    with host_readback(device):
        held = flags.tolist()
    for ok, msg in zip(held, messages):
        if not ok:
            raise RoundCheckError(f"debug_checks: round {rnd}: {msg}")


class RebuildDetector:
    """Raises if a repeat of a run rebuilds one of the engine's memoised
    round functions.

    ``check(signature)`` runs at the end of each ``run()``; the
    signature names what the run may build (policy traits, telemetry
    level).  A run with a signature not seen before may add memo entries
    (a new policy or level builds its own); a run repeating a seen
    signature may not: any memo cache grown since the last check raises
    :class:`RoundCheckError` naming it."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self._sizes: Dict[str, int] = {}
        self._seen: set = set()

    def _caches(self) -> Iterator[Tuple[str, int]]:
        eng = self.engine
        yield "trainer", int(getattr(eng, "_trainer", None) is not None)
        for attr in ("_dyn_cache", "_server_steps", "_cut_fns",
                     "_metrics_fns"):
            yield attr.lstrip("_"), len(getattr(eng, attr, {}))
        yield "kernel_libraries", _build.load.cache_info().currsize

    def check(self, signature) -> None:
        sizes = dict(self._caches())
        if signature in self._seen:
            grown = [f"{name} {self._sizes.get(name, 0)} -> {n}"
                     for name, n in sizes.items()
                     if n > self._sizes.get(name, 0)]
            if grown:
                raise RoundCheckError(
                    f"debug_checks: a repeat run {signature!r} rebuilt "
                    f"memoised round functions ({', '.join(grown)}) — a "
                    f"round-path input changed shape, dtype or placement "
                    f"between runs; the engine's memo keys must be "
                    f"stable")
        self._seen.add(signature)
        self._sizes = sizes
