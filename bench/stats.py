"""Percentiles and waits, as the benchmark's metrics take them."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear interpolation), or None
    with no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def censored(first: Optional[float], due: float, close: float) -> float:
    """Seconds a request waited for its first token: from when it was due
    to its first token, or to the window's close if none came by then, so
    a stall cannot hide."""
    end = close if first is None or first > close else first
    return max(0.0, end - due)
