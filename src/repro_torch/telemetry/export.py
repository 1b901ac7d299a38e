"""Chrome ``trace_event`` conversion + schema validation.

``spans_to_chrome`` turns :class:`repro_torch.telemetry.tracer.Span` records
into the Chrome trace-event JSON object format (an object with a
``traceEvents`` list of "X" complete events), loadable in chrome://tracing
or https://ui.perfetto.dev.  Each tracer *track* becomes its own pid with
a ``process_name`` metadata event, so the wall-clock engine timeline and
the simulated-clock timeline render side by side without sharing a time
base.

The reference's schema validator (``python -m repro.telemetry.export``)
reads the files this writes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence


def spans_to_chrome(spans: Sequence) -> Dict[str, Any]:
    """Convert Span records to a Chrome trace-event JSON object.

    Timestamps are re-based per track (each track's earliest span becomes
    t=0) and scaled to microseconds, the unit the format requires.
    """
    tracks: List[str] = []
    for sp in spans:
        if sp.track not in tracks:
            tracks.append(sp.track)
    pid_of = {t: i + 1 for i, t in enumerate(tracks)}
    t0_of: Dict[str, float] = {}
    for sp in spans:
        t0_of[sp.track] = min(t0_of.get(sp.track, sp.ts), sp.ts)

    events: List[Dict[str, Any]] = []
    for track in tracks:
        events.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": pid_of[track], "tid": 0,
                       "args": {"name": track}})
    for sp in spans:
        ev: Dict[str, Any] = {
            "name": sp.name, "ph": "X", "cat": sp.track,
            "ts": (sp.ts - t0_of[sp.track]) * 1e6,
            "dur": max(0.0, sp.dur) * 1e6,
            "pid": pid_of[sp.track], "tid": 0,
        }
        if sp.args:
            ev["args"] = dict(sp.args)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
