"""Tracer: nested wall-clock spans, ring-buffered, Chrome-trace exportable.

The engine's control loop is host-driven Python around one model call
per step, so host-side spans capture exactly the boundaries that matter for
the online dispatcher: admit / fused_step / rebalance.

Design constraints:

  * **Disabled mode is zero-cost.**  ``span()`` on a disabled tracer
    returns a shared no-op context manager — no per-call allocation, no
    clock reads — and ``sync()`` is a no-op, so the fast path pays one
    attribute check per call site.
  * **Bounded memory.**  Completed spans land in a ``deque(maxlen=...)``
    ring buffer; aggregate per-name duration/count totals survive ring
    overflow (the dispatcher and the profiler fit consume totals and
    recent spans, not unbounded history).
  * **Two time bases.**  Context-manager spans use the wall clock
    (``time.perf_counter``, optionally device-sync'd via ``sync()``);
    ``add_span`` records spans on explicit timelines — the engine and the
    DES place *simulated-clock* module spans on their own track, which the
    Chrome export maps to a separate pid so Perfetto renders both.

Export: ``export_chrome()`` / ``write_chrome()`` produce Chrome
``trace_event`` JSON ("X" complete events) loadable in chrome://tracing or
https://ui.perfetto.dev; see ``repro_torch.telemetry.export`` for the schema
validator CLI.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One completed span.  ``ts``/``dur`` are seconds in the track's own
    time base (wall clock for ``track="main"``, caller-defined otherwise);
    ``depth`` is the nesting level at record time."""

    name: str
    ts: float
    dur: float
    depth: int
    track: str
    args: Optional[Dict[str, Any]]


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("tracer", "name", "args", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        tr = self.tracer
        self.depth = len(tr._stack)
        tr._stack.append(self)
        self.t0 = tr._time()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        dur = tr._time() - self.t0
        tr._stack.pop()
        tr._record(Span(self.name, self.t0, dur, self.depth, "main",
                        self.args))
        return False


class Tracer:
    """Nested-span tracer with a ring buffer and per-name totals."""

    def __init__(self, enabled: bool = False, capacity: int = 65536,
                 time_fn=time.perf_counter):
        self.enabled = enabled
        self._time = time_fn
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self._stack: List[_SpanCtx] = []
        # aggregate duration / count per span name; survives ring overflow
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    # ------------------------------------------------------------- recording
    def span(self, name: str, args: Optional[Dict[str, Any]] = None):
        """Context manager timing a nested wall-clock span.  On a disabled
        tracer this returns a shared no-op object (no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, args)

    def sync(self, x) -> None:
        """Wait until the work producing tensor ``x`` is done — called
        inside a span so the recorded duration is device-sync'd (a CUDA
        synchronize; CPU tensors are ready on return).  No-op disabled."""
        if not self.enabled or x is None:
            return
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    def add_span(self, name: str, ts: float, dur: float, track: str = "main",
                 depth: int = 0, args: Optional[Dict[str, Any]] = None
                 ) -> None:
        """Record a span with an explicit (ts, dur) on an explicit track —
        used for simulated-clock timelines (engine sim clock, DES)."""
        if not self.enabled:
            return
        self._record(Span(name, ts, dur, depth, track, args))

    def add_phase_spans(self, prefix: str, ts: float, dur: float,
                        weights: Dict[str, float], track: str = "main",
                        depth: int = 0,
                        args: Optional[Dict[str, Any]] = None) -> None:
        """Attribute ONE measured span to several phases: split ``[ts,
        ts + dur)`` into consecutive ``<prefix><phase>`` child spans whose
        durations are proportional to ``weights`` (zero-weight phases are
        skipped).  Used by the engine's fused prefill+decode step, where
        both phases execute inside a single model call and only their
        token shares are known."""
        if not self.enabled:
            return
        total = sum(w for w in weights.values() if w > 0.0)
        if total <= 0.0:
            return
        t = ts
        for phase, w in weights.items():
            if w <= 0.0:
                continue
            d = dur * w / total
            self._record(Span(f"{prefix}{phase}", t, d, depth, track, args))
            t += d

    def _record(self, sp: Span) -> None:
        self.events.append(sp)
        self.totals[sp.name] = self.totals.get(sp.name, 0.0) + sp.dur
        self.counts[sp.name] = self.counts.get(sp.name, 0) + 1

    # --------------------------------------------------------------- reading
    def spans(self, name: Optional[str] = None,
              track: Optional[str] = None) -> List[Span]:
        out = []
        for sp in self.events:
            if name is not None and sp.name != name:
                continue
            if track is not None and sp.track != track:
                continue
            out.append(sp)
        return out

    def total(self, name: str) -> float:
        """Aggregate recorded duration (seconds) of all spans named
        ``name`` — O(1), survives ring overflow."""
        return self.totals.get(name, 0.0)

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)

    def __len__(self) -> int:
        return len(self.events)

    def reset(self) -> None:
        self.events.clear()
        self._stack.clear()
        self.totals.clear()
        self.counts.clear()

    # ---------------------------------------------------------------- export
    def export_chrome(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object (see export.spans_to_chrome)."""
        from repro_torch.telemetry.export import spans_to_chrome
        return spans_to_chrome(list(self.events))

    def write_chrome(self, path: str) -> int:
        """Write the Chrome trace to ``path``; returns the event count."""
        import json
        obj = self.export_chrome()
        with open(path, "w") as f:
            json.dump(obj, f)
        return len(obj["traceEvents"])
