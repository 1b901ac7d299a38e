"""itl_p99_ms: the 99th percentile of every gap between two successive
tokens of a request (host clock at the step() returns), over the gaps that
end in the window."""

from bench import stats


def read(w):
    p = stats.percentile([g for _, g in w.gaps], 99)
    return None if p is None else p * 1e3
