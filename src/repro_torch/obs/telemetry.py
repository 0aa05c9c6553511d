"""The telemetry session ``FleetEngine.run(telemetry=...)`` takes.

``Telemetry`` holds the three observability layers behind one handle:

* ``level`` — which device metrics run (``"basic"`` | ``"full"``, see
  ``repro_torch.obs.metrics``; None: none, spans and events only).
  Their values are appended to the round ledger's read-back row: no
  added wait for the card.
* ``tracer`` — host spans of the round loop's seams
  (``repro_torch.obs.trace``); ``trace=`` saves the Chrome / Perfetto
  ``trace_event`` JSON at run end.
* ``sink`` — the event stream (``run_start`` / ``round`` / ``run_end``
  dicts).  ``jsonl=`` appends to a JSONL file (the input of
  ``python -m repro_torch.obs.report``); the events of the last run are
  also kept in ``last_events``.

``profile_rounds=(start, stop)`` runs a ``torch.profiler`` window over
those rounds (CPU and, on a card, CUDA activity); the spans show there
as ``record_function`` ranges.  ``last_profile`` holds the finished
profiler (``key_averages()``), and with ``profile_dir`` its Chrome trace
is exported there as ``trace.json``.

Typical use::

    tel = Telemetry(level="full", jsonl="run.jsonl",
                    trace="run.trace.json")
    hist = engine.run("flude", telemetry=tel)
    # -> python -m repro_torch.obs.report run.jsonl
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.sink import JsonlSink, MemorySink, TeeSink
from repro_torch.obs.trace import Tracer


class Telemetry:
    def __init__(self, level: Optional[str] = "full",
                 jsonl: Optional[str] = None,
                 trace: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 profile_rounds: Optional[Tuple[int, int]] = None):
        if level is not None and level not in _metrics.LEVELS:
            raise ValueError(
                f"telemetry level must be one of {_metrics.LEVELS}, got "
                f"{level!r}")
        self.level = level
        self.tracer = Tracer()
        self.trace_path = trace
        self._memory = MemorySink()
        self.sink = TeeSink(self._memory,
                            JsonlSink(jsonl) if jsonl else None)
        self.profile_dir = profile_dir
        self.profile_rounds = profile_rounds
        self._profiler = None
        self.last_profile = None
        self._run_mark = 0

    @property
    def last_events(self):
        """Events of the most recent run (memory buffer)."""
        return self._memory.events[self._run_mark:]

    # -- engine protocol ----------------------------------------------------

    def open_run(self, meta: dict) -> None:
        self._run_mark = len(self._memory.events)
        self.tracer.reset()
        self.sink.emit({"kind": "run_start", "level": self.level, **meta})

    def record_round(self, row: dict) -> None:
        self.sink.emit({"kind": "round", **row})

    def maybe_profile(self, rnd: int) -> None:
        """Start or stop the ``torch.profiler`` window at round ``rnd``."""
        if self.profile_rounds is None:
            return
        start, stop = self.profile_rounds
        if rnd == start and self._profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.__enter__()
        elif rnd > stop and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        self.last_profile = prof
        if self.profile_dir is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.profile_dir,
                                                  "trace.json"))

    def close_run(self, summary: dict) -> None:
        self._stop_profile()
        self.sink.emit({"kind": "run_end",
                        "spans": self.tracer.summary(), **summary})
        if self.trace_path is not None:
            self.tracer.save(self.trace_path)

    def close(self) -> None:
        self._stop_profile()
        self.sink.close()
