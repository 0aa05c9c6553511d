"""Observability of the fleet round path (port of ``repro.obs``):

* ``repro_torch.obs.metrics`` — ``@register_metric`` device-metric
  registry; the values ride the round ledger's read-back (no added wait
  for the card).
* ``repro_torch.obs.trace`` — host span tracer (each span also a
  ``torch.profiler`` range) with Chrome / Perfetto export.
* ``repro_torch.obs.sink`` — JSONL / in-memory event sinks.
* ``repro_torch.obs.telemetry`` — the ``Telemetry`` session
  ``FleetEngine.run(telemetry=...)`` takes.
* ``repro_torch.obs.report`` — ``python -m repro_torch.obs.report
  run.jsonl``, the run summary CLI.
"""
from repro_torch.obs.metrics import (available_metrics, make_metrics_fn,
                                     metrics_for, register_metric)
from repro_torch.obs.sink import JsonlSink, MemorySink, TeeSink
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer
