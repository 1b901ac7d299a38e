"""Telemetry: span tracing + typed metrics feeding the dispatcher.

  * :class:`Tracer` — nested spans (wall-clock or explicit simulated
    timelines), ring-buffered, exportable as Chrome ``trace_event`` JSON
    and checked by ``validate_chrome_trace`` (CLI: ``python -m
    repro_torch.telemetry.export TRACE.json``).
  * :class:`MetricsRegistry` — counters / gauges / histograms with lazy
    percentiles and EWMA smoothing; ``snapshot()`` feeds the dispatcher,
    hauler, and cost model with *measured* values.
  * :func:`count_recompiles` — counts the distinct bucket shapes a model
    callable has been called with, so bucketing regressions trip metrics.
"""

from repro_torch.telemetry.export import (spans_to_chrome,
                                          validate_chrome_trace,
                                          validate_file)
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry, MetricsView,
                                           count_recompiles)
from repro_torch.telemetry.tracer import Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsView",
    "Span", "Tracer", "count_recompiles", "spans_to_chrome",
    "validate_chrome_trace", "validate_file",
]
