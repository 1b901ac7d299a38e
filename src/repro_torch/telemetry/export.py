"""Chrome ``trace_event`` conversion + schema validation.

``spans_to_chrome`` turns :class:`repro_torch.telemetry.tracer.Span` records
into the Chrome trace-event JSON object format (an object with a
``traceEvents`` list of "X" complete events), loadable in chrome://tracing
or https://ui.perfetto.dev.  Each tracer *track* becomes its own pid with
a ``process_name`` metadata event, so the wall-clock engine timeline and
the simulated-clock timeline render side by side without sharing a time
base.

``validate_chrome_trace`` / the ``python -m repro_torch.telemetry.export
FILE`` CLI enforce the schema: the file parses, is non-empty, and every
event carries ``name/ph/ts/pid/tid`` (with ``dur >= 0`` on "X" events).
The CLI exits 0 on a valid trace, 1 on an invalid or unreadable one and 2
on a wrong argument count.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Sequence

REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


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


def validate_chrome_trace(obj: Any) -> int:
    """Validate a parsed Chrome trace object; returns the number of "X"
    span events.  Raises ``ValueError`` on any schema violation."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    n_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key in REQUIRED_KEYS:
            if key not in ev:
                raise ValueError(f"event {i} missing required key {key!r}")
        if not isinstance(ev["name"], str) or not isinstance(ev["ph"], str):
            raise ValueError(f"event {i}: name/ph must be strings")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i}: ts must be a number")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i}: X event needs dur >= 0")
            n_spans += 1
    if n_spans == 0:
        raise ValueError("trace contains no span (ph='X') events")
    return n_spans


def validate_file(path: str) -> int:
    with open(path) as f:
        obj = json.load(f)
    return validate_chrome_trace(obj)


def main(argv: Sequence[str]) -> int:
    if len(argv) != 1:
        print("usage: python -m repro_torch.telemetry.export TRACE.json",
              file=sys.stderr)
        return 2
    try:
        n = validate_file(argv[0])
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"INVALID {argv[0]}: {e}", file=sys.stderr)
        return 1
    print(f"OK {argv[0]}: {n} span events")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
