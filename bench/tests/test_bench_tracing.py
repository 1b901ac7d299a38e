"""The readers of the program's host spans and call-clock arguments, on
synthetic windows: ``launch_ms_step``, ``device_ms_step`` and
``exchange_ms_step`` read their value, read None where the program
records no such span or argument (a program without them, as an older
one), and ``host_ms_step`` reads the same with the step's leaf spans
inside it as without them."""

import pytest

from bench.tests import _tiny
from bench import harness
from repro_torch.telemetry.tracer import Span


def span(name, ts, dur, depth, args=None):
    return Span(name, ts, dur, depth, "main", args)


def steps(leaves, clock=True):
    """Three fused steps of 40 ms at 0.1 s apart, each with its call span
    (10 ms from 5 ms into the step); with ``leaves`` the leaf spans that
    cover the rest (``graph/replay`` 2, 3 and 4 ms), with ``clock`` the
    call clock's arguments (device 6, 7, 8 ms; exchange 1, 2, 3 ms)."""
    out = []
    for i in range(3):
        t = 1.0 + 0.1 * i
        args = {"batch": 8, "chunk": 1, "pages": 4, "decode_rows": 5,
                "prefill_tokens": 0}
        if clock:
            args.update(device_ms=6.0 + i, exchange_ms=1.0 + i)
        out.append(span("step", t, 0.040, 0))
        out.append(span("fused_step", t + 0.005, 0.010, 1, args))
        if leaves:
            replay = 0.002 + 0.001 * i
            out += [span("admit", t, 0.001, 1),
                    span("pack", t + 0.001, 0.004, 1,
                         {"rows": 5, "gather_lanes": 12}),
                    span("graph/replay", t + 0.005, replay, 2),
                    span("wait", t + 0.005 + replay, 0.010 - replay, 2),
                    span("commit", t + 0.015, 0.005, 1),
                    span("balance", t + 0.020, 0.010, 1),
                    span("balance", t + 0.030, 0.010, 1)]
    return out


def window(spans, n_steps=3):
    return harness.Window(_tiny.cell(), 0.0, 2.0, 1.0, [], [], 0,
                          [harness.Step(1.0 + 0.1 * i, 1.04 + 0.1 * i)
                           for i in range(n_steps)], {}, spans)


def read(metric, w):
    return harness.reader(metric).read(w)


def test_the_readers_values():
    w = window(steps(leaves=True))
    assert read("launch_ms_step.online", w) == pytest.approx(3.0)
    assert read("device_ms_step.online", w) == pytest.approx(7.0)
    assert read("exchange_ms_step.online", w) == pytest.approx(2.0)
    # the split schedule's calls count too, a step's exchange summed
    split = [span("step", 1.0, 0.04, 0),
             span("prefill_chunk", 1.0, 0.01, 1,
                  {"device_ms": 4.0, "exchange_ms": 0.5}),
             span("paged_decode", 1.02, 0.01, 1,
                  {"device_ms": 3.0, "exchange_ms": 1.5})]
    w = window(split, n_steps=1)
    assert read("device_ms_step.online", w) == pytest.approx(3.5)
    assert read("exchange_ms_step.online", w) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", ["launch_ms_step.online",
                                    "device_ms_step.online",
                                    "exchange_ms_step.online"])
def test_none_without_the_spans_or_args(metric):
    # the parent's program: no leaf spans, no call clock
    assert read(metric, window(steps(leaves=False, clock=False))) is None
    assert read(metric, window([])) is None


def test_none_for_the_clock_without_its_args():
    w = window(steps(leaves=True, clock=False))
    assert read("launch_ms_step.online", w) == pytest.approx(3.0)
    assert read("device_ms_step.online", w) is None
    assert read("exchange_ms_step.online", w) is None
    assert read("exchange_ms_step.online",
                window(steps(leaves=True), n_steps=0)) is None


def test_host_ms_step_is_unchanged_by_the_leaf_spans():
    bare = read("host_ms_step.online", window(steps(leaves=False)))
    assert bare == pytest.approx(30.0)
    assert read("host_ms_step.online", window(steps(leaves=True))) == bare
