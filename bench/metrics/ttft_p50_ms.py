"""ttft_p50_ms: the median, over every request due in the window, of the
host time from when it was due to the step() that returned its first
token; a request with none by the window's close enters at its wait so
far."""

from bench import stats


def read(w):
    waits = [stats.censored(first, due, w.close) for due, first in w.due]
    p = stats.percentile(waits, 50)
    return None if p is None else p * 1e3
