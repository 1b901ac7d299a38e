"""The device's side of a traced window, from ``torch.profiler``.

A :class:`DeviceTrace` is started and stopped around steps of the
window.  It reads every device activity (kernels, copies, memsets) of the
trace, the busy time as the union of their intervals, the time of each
kernel by name, and the idle gaps between busy intervals, each put on the
host's clock through a marker recorded at a known host time, so the host
span open during a gap can name it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

MARK = "bench.clock_mark"


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t_start = self.t_stop = self.t_mark = 0.0

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        self.t_start = time.perf_counter()
        with torch.profiler.record_function(MARK):
            self.t_mark = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def intervals(self) -> Tuple[List[Tuple[float, float, str]], float]:
        """(device activities as (start, end, name) in host seconds,
        sorted; the offset added to the profiler's clock)."""
        dev, mark = [], None
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                s = e.start_ns() / 1e9
                dev.append((s, s + e.duration_ns() / 1e9, e.name()))
            elif e.name() == MARK:
                mark = e.start_ns() / 1e9
        if mark is None:
            raise RuntimeError("the trace holds no clock mark")
        off = self.t_mark - mark
        return sorted((s + off, t + off, n) for s, t, n in dev), off

    def read(self, host_spans: Sequence[Tuple[str, float, float]]) -> Dict:
        """busy_s, window_s, seconds per kernel name, and the longest idle
        gaps each named by the innermost host span (name, start, end)
        open at its middle."""
        acts, _ = self.intervals()
        by_name: Dict[str, float] = {}
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, n in acts:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            gaps = ([(self.t_start, acts[0][0])] + gaps
                    + [(cur_e, self.t_stop)])
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        idle = [[label(host_spans, (a + b) / 2), b - a] for a, b in longest]
        return {"busy_s": busy, "window_s": self.t_stop - self.t_start,
                "kernels": by_name, "idle_gaps": idle}


def label(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost (shortest) span holding time ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "no host span"
