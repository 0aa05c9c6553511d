"""Telemetry event sinks.

Events are flat JSON-serialisable dicts with a ``kind``:

* ``run_start`` — one per ``FleetEngine.run``: policy, fleet size,
  telemetry level and the round path's configuration.
* ``round``     — one per resolved round: the History row and every
  metric of the level (read back with the round ledger, so events follow
  the pipelined resolve, not the round itself).
* ``run_end``   — run totals: rounds, final accuracy, comm and wall
  clock, the per-span host-time summary and the engine's transfer
  counters.

``JsonlSink`` appends one JSON line per event (the input of
``python -m repro_torch.obs.report``); ``MemorySink`` keeps events in a
list (tests, programmatic readers).
"""
from __future__ import annotations

import json
from typing import List


class JsonlSink:
    """One JSON object per line, appended to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps(event, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class MemorySink:
    """In-process event buffer."""

    def __init__(self):
        self.events: List[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class TeeSink:
    """Fans one event stream out to several sinks."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def emit(self, event: dict) -> None:
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
