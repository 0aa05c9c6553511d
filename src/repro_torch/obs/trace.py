"""Host span tracing of the fleet round path.

The engine's host work a round is a short sequence of seams — process
step, plan, trainer, round cut, metrics, server step, observe, ledger
resolve, cache stream, eval — and :class:`Tracer` wraps each in a span:
a ``time.perf_counter`` pair and one appended tuple.  The round path is
asynchronous on the card, so a span measures its seam's host cost (the
launches it issues and any wait it makes), the budget the zero-wait
contract of the round loop protects.  Each span also opens a
``torch.profiler.record_function`` range of its name, so a profiler
window (``repro_torch.obs.telemetry.Telemetry``) shows the span, and the
device time of the kernels it launched, on the device timeline.

Spans export as Chrome ``trace_event`` JSON (``save``), loadable in
Perfetto or ``chrome://tracing``, and sum into a per-name summary
(``summary``) that the report CLI prints as the round-time breakdown.

``NULL_TRACER`` is the disabled path: ``span`` returns one shared no-op
context manager, so instrumented code needs no branches and a run with
telemetry off pays one attribute lookup a seam.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from torch.profiler import record_function


class Span:
    """One timed section; ``with tracer.span(..) as sp`` also gives its
    ``seconds``."""

    __slots__ = ("_tracer", "name", "args", "t0", "t1", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0
        self._range = None

    def __enter__(self) -> "Span":
        self._range = record_function(self.name)
        self._range.__enter__()
        self.t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self._tracer._clock()
        self._range.__exit__(*exc)
        self._range = None
        self._tracer._record(self)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Append-only span recorder on a perf_counter clock; timestamps are
    relative to the last ``reset``."""

    def __init__(self):
        self._clock = time.perf_counter
        self.reset()

    def reset(self) -> None:
        self._epoch = self._clock()
        # (name, ts_us, dur_us, args)
        self.events: List[Tuple[str, float, float, Optional[dict]]] = []

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **args) -> Span:
        return Span(self, name, args or None)

    def _record(self, sp: Span) -> None:
        self.events.append((sp.name, (sp.t0 - self._epoch) * 1e6,
                            (sp.t1 - sp.t0) * 1e6, sp.args))

    # -- aggregation / export -----------------------------------------------

    def summary(self) -> Dict[str, dict]:
        """Per-span-name totals: count, total / mean / max seconds."""
        out: Dict[str, dict] = {}
        for name, _ts, dur, _args in self.events:
            s = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                      "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += dur * 1e-6
            s["max_s"] = max(s["max_s"], dur * 1e-6)
        for s in out.values():
            s["mean_s"] = s["total_s"] / s["count"]
        return out

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON (loadable in Perfetto)."""
        evs = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                "args": {"name": "fleet-engine host"}}]
        for name, ts, dur, args in self.events:
            ev = {"name": name, "ph": "X", "pid": 0, "tid": 0, "ts": ts,
                  "dur": dur, "cat": "fl"}
            if args:
                ev["args"] = args
            evs.append(ev)
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    seconds = 0.0


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op (one shared span)."""

    events: List = []

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def summary(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_TRACER = NullTracer()
