"""Telemetry: span tracing + typed metrics feeding the dispatcher.

  * :class:`Tracer` — nested spans (wall-clock or explicit simulated
    timelines), ring-buffered, exportable as Chrome ``trace_event`` JSON.
  * :class:`MetricsRegistry` — counters / gauges / histograms with lazy
    percentiles and EWMA smoothing; ``snapshot()`` feeds the dispatcher,
    hauler, and cost model with *measured* values.
  * :func:`count_recompiles` — counts the distinct bucket shapes a model
    callable has been called with, so bucketing regressions trip metrics.
"""

from repro_torch.telemetry.export import spans_to_chrome
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry, MetricsView,
                                           count_recompiles)
from repro_torch.telemetry.tracer import Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsView",
    "Span", "Tracer", "count_recompiles", "spans_to_chrome",
]
