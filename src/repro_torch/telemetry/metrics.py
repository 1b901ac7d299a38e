"""Typed metrics: counters, gauges, histograms with lazy percentiles.

Replaces the engine's flat ad-hoc ``metrics`` dict.  Three instrument
types, one flat namespace:

  * :class:`Counter` — monotonically increasing float (h2d/d2h bytes,
    steps, evictions, new bucket shapes).
  * :class:`Gauge` — point-in-time value.  A gauge may wrap a *callable*
    (``fn=``) evaluated lazily at read time, so per-device KV-pool
    occupancy costs nothing per step; ``ewma()`` folds a noisy sample into
    an exponentially-weighted moving average so one slow step does not
    trigger a migration storm downstream.
  * :class:`Histogram` — bounded reservoir of recent observations with
    count/sum/min/max running aggregates and an EWMA.  Percentiles are
    computed **lazily** at ``percentile()`` / ``summary()`` time (the old
    engine recomputed ``np.percentile`` over the full TTFT list on every
    request finish — O(n) per finish; observing is now O(1)).

``MetricsRegistry.snapshot(prefix=None)`` flattens everything into a
``{name: value}`` dict (histograms expand to ``name/p50`` etc.); the
dispatcher, hauler, and cost model consume prefix-filtered snapshots so
redispatch decisions read *measured* signals instead of purely analytic
profiles.  ``MetricsView`` keeps ``engine.metrics[...]`` working as a
read-only mapping over the registry.
"""

from __future__ import annotations

import collections
from collections.abc import Mapping
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("name", "_value", "fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._value = float(v)

    def ewma(self, v: float, alpha: float = 0.25) -> float:
        """Fold a sample into an EWMA of the gauge value; returns it."""
        if self.fn is not None:
            raise ValueError(f"gauge {self.name} is callable-backed")
        if self._value == 0.0:
            self._value = float(v)
        else:
            self._value = (1.0 - alpha) * self._value + alpha * float(v)
        return self._value

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value


class Histogram:
    """Reservoir of the most recent ``window`` observations + running
    aggregates.  ``observe`` is O(1); percentiles are evaluated lazily."""

    __slots__ = ("name", "_window", "count", "total", "min", "max",
                 "ewma", "alpha")

    def __init__(self, name: str, window: int = 8192, alpha: float = 0.25):
        self.name = name
        self._window: collections.deque = collections.deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.ewma = 0.0
        self.alpha = alpha

    def observe(self, v: float) -> None:
        v = float(v)
        self._window.append(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.ewma = v if self.count == 1 \
            else (1.0 - self.alpha) * self.ewma + self.alpha * v

    def percentile(self, q: float) -> float:
        """q-th percentile over the retained window (0.0 when empty)."""
        if not self._window:
            return 0.0
        return float(np.percentile(np.fromiter(self._window, np.float64), q))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0.0}
        vals = np.fromiter(self._window, np.float64)
        p50, p95, p99 = (float(x) for x in np.percentile(vals, (50, 95, 99)))
        return {"count": float(self.count), "mean": self.mean,
                "min": self.min, "max": self.max, "ewma": self.ewma,
                "p50": p50, "p95": p95, "p99": p99}


class MetricsRegistry:
    """Flat namespace of typed instruments, create-or-get semantics."""

    def __init__(self):
        self._by_name: Dict[str, object] = {}

    def _get(self, name: str, cls, factory):
        inst = self._by_name.get(name)
        if inst is None:
            inst = factory()
            self._by_name[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, Gauge, lambda: Gauge(name, fn))
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, window: int = 8192,
                  alpha: float = 0.25) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, window, alpha))

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
        """Flatten to ``{name: value}``; histograms expand to
        ``name/count|mean|min|max|ewma|p50|p95|p99``.  ``prefix`` filters
        by name prefix so hot-path consumers (the dispatcher reading
        ``attn/device/``) do not force every histogram's percentiles."""
        out: Dict[str, float] = {}
        for name, inst in self._by_name.items():
            if prefix is not None and not name.startswith(prefix):
                continue
            if isinstance(inst, Histogram):
                for k, v in inst.summary().items():
                    out[f"{name}/{k}"] = v
            else:
                out[name] = inst.value  # type: ignore[union-attr]
        return out


class MetricsView(Mapping):
    """Read-only mapping facade over registry instruments — keeps the
    engine's historical ``metrics["h2d_bytes"]`` interface alive while the
    values live in typed instruments (and derived keys like ``ttft_p50``
    are computed lazily at read time)."""

    def __init__(self, readers: Dict[str, Callable[[], float]]):
        self._readers = dict(readers)

    def __getitem__(self, key: str) -> float:
        return self._readers[key]()

    def __iter__(self) -> Iterator[str]:
        return iter(self._readers)

    def __len__(self) -> int:
        return len(self._readers)

    def __repr__(self) -> str:
        return repr({k: self[k] for k in self._readers})


def _shape_key(x):
    """The shapes of every array leaf of nested dicts, lists and tuples,
    with the nesting (jit's cache key, less the dtypes)."""
    if isinstance(x, dict):
        return tuple((k, _shape_key(x[k])) for k in sorted(x, key=repr))
    if isinstance(x, (list, tuple)):
        return tuple(_shape_key(v) for v in x)
    return tuple(x.shape) if hasattr(x, "shape") else None


class ShapeCountingFn:
    """Wraps a model callable; bumps ``counter`` the first time it is
    called with a new combination of argument shapes — those of every
    tensor leaf, nested dicts, lists and tuples included, as jit keys its
    cache on every leaf of the argument pytrees.

    The counterpart of the reference's jit-recompile counter is the number
    of distinct bucket shapes a callable has seen: the quantity the
    engine's ``fused_bucket_count()`` bounds.  ``_cache_size()`` reads it.
    This wrapper runs the callable eagerly (the engine's dense calls); the
    paged calls' ``serving.graphs.CapturedFn`` counts the same way and
    captures one CUDA graph per shape."""

    __slots__ = ("fn", "counter", "shapes")

    def __init__(self, fn, counter: Counter):
        self.fn = fn
        self.counter = counter
        self.shapes: set = set()

    def _count(self, args_kwargs) -> tuple:
        """The shape key of ``(args, kwargs)``, counted if new."""
        key = _shape_key(args_kwargs)
        if key not in self.shapes:
            self.shapes.add(key)
            self.counter.inc()
        return key

    def __call__(self, *args, **kwargs):
        self._count((args, kwargs))
        return self.fn(*args, **kwargs)

    def _cache_size(self) -> int:
        return len(self.shapes)


def count_recompiles(fn, counter: Counter) -> ShapeCountingFn:
    return ShapeCountingFn(fn, counter)
