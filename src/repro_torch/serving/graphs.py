"""One captured CUDA graph per argument shape: the port's counterpart of
the reference's ``jax.jit`` where the reference runs a jitted function.
The engine's paged calls (``jax.jit(..., donate_argnums=(1, 2))`` around
``_paged_fn``, ``_chunk_fn`` and ``_fused_fn``, ``repro/serving/
engine.py``), the train step (``@jax.jit step_fn``, ``repro/training/
train_loop.py``) and ``profile_attention``'s timed call (``repro/core/
profiler.py``) go through :class:`CapturedFn`.

jit compiles a call once per argument shape and runs the compiled program
on every later call of that shape.  :class:`CapturedFn` does the same with
CUDA graphs.  The first call of a shape runs the function for real on a
side stream (which builds and loads the kernels' libraries and fills
their host caches), then captures it on that stream.  Every later call of
the shape copies its host arrays into the shape's static inputs (one
pinned staging buffer, one copy) and replays the graph: every kernel of
the call in one host call.  Device tensors passed in (the params and
pools, the optimizer state) are read and updated in place, as jit's
donated buffers are.

What a replay must keep:

* Launch counts.  The kernel wrappers count their launches on the host
  (``LAUNCHES`` of each kernel package), and a replay runs no Python.  A
  capture runs no kernel either, so what it counted is taken back, kept
  with the shape and added on every replay.  Every dict in ``TALLIES``
  is kept so; one added there while a shape is captured gets its replays.
* Memory.  A graph reads and writes the addresses it was captured on: its
  static inputs and outputs and the device tensors passed in (params,
  pools, optimizer state).  (The kernels' TMA tensor maps, encoded on the
  host from base pointers, are baked in by value.)  A call whose device
  tensors are other tensors than the captured ones raises rather than
  replay over memory it does not own.  The static outputs are the same
  tensors on every replay of a shape: read them before the next call of
  that shape.  A function that keeps state across calls keeps it in
  tensors it updates in place (AdamW's step counter), never in new ones.
* The decode tile's tickets (``paged_attention.ops._tickets``), cached
  per stream and kept for good once made: the warm-up on the capture
  stream makes them, so the capture finds them.

Every graph of one :class:`CudaGraphs` (one engine's, one training run's)
allocates from one memory pool: replays run one at a time on the current
stream.

Telemetry: a wrapper records its calls on its owner's tracer
(``CudaGraphs.tracer``, an untraced one unless the owner gives its own), a
replayed call as a ``graph/replay`` span (the shape key, the pointer
check, the staging and the replay's host call), a shape's first call as a
``graph/capture`` span (its warm-up and capture seconds as args).  The
engine's paged calls also record :class:`CallClock`'s events on the
device, which a capture takes into the graph.

On CPU tensors, and inside :func:`disable_capture` (the counterpart of
``jax.disable_jit()``), the wrapper calls the function directly.  There is
no fallback: on the card a capture that fails raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.telemetry.metrics import (Counter, ShapeCountingFn,
                                           _shape_key)
from repro_torch.telemetry.tracer import Tracer

# host-side counts that the code under a capture bumps where it launches
# device work (the kernel wrappers' launches); see the module docstring
TALLIES: List[Dict] = [pa_ops.LAUNCHES, pa_ops.PREFILL_TILE_LAUNCHES,
                       fa_ops.LAUNCHES]
_DISABLED = [0]            # depth of nested disable_capture() blocks


@contextlib.contextmanager
def disable_capture():
    """Run every captured wrapper's calls eagerly inside the block: no
    capture, no replay (the counterpart of ``jax.disable_jit()``)."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def _leaves(tree) -> list:
    """The tensor leaves of nested dicts (in key order, as the shape key
    takes them: a restored tree may hold its keys in another order),
    lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=repr) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _ptrs(tree) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in _leaves(tree))


class CallClock:
    """Four timing events of one paged call on the device
    (``transformer._on_anchor`` records them): at its start, after the
    exchange's gather into the anchor, before its write-back, and at its
    end.  Recorded while a stream is captured, each is an event-record
    node of the graph (``external=True``), so every replay records it
    anew.  Read after the device has finished the call."""

    def __init__(self):
        self.events = tuple(torch.cuda.Event(enable_timing=True,
                                             external=True)
                            for _ in range(4))

    def read(self) -> Dict[str, float]:
        """The last call's ``device_ms`` (start to end) and
        ``exchange_ms`` (the gather and the write-back)."""
        e = self.events
        return {"device_ms": e[0].elapsed_time(e[3]),
                "exchange_ms": e[0].elapsed_time(e[1])
                + e[2].elapsed_time(e[3])}


class CudaGraphs:
    """What the captured wrappers of one owner share on ``device``: one
    memory pool for every graph, the side stream each shape is warmed up
    and captured on, the pinned buffer host arrays are staged in, and the
    tracer their calls' spans go to.  Nothing is allocated before the
    first capture."""

    def __init__(self, device, tracer: Optional[Tracer] = None):
        self.device = torch.device(device)
        self.tracer = tracer if tracer is not None else Tracer()
        self._pool = self._stream = None
        self._host = self._host_np = self._copied = None

    def captures(self) -> bool:
        """Whether calls on this device are captured: on CUDA only."""
        return self.device.type == "cuda"

    def _side(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def run(self, fn, args):
        """``fn(*args)`` for real on the side stream, after the current
        stream's work and before its later work; returns once the device
        has finished it."""
        cur = torch.cuda.current_stream(self.device)
        side = self._side()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)
        cur.wait_stream(side)
        for t in _leaves(out):      # made on the side stream, read on this
            t.record_stream(cur)
        torch.cuda.synchronize(self.device)
        return out

    def capture(self, fn, args):
        """(graph, outputs) of ``fn(*args)`` captured on the side stream
        into the shared pool; nothing runs.  The cyclic garbage collector
        is held off meanwhile: a collection inside the capture could free
        a dead owner's graph, which CUDA forbids while a stream captures
        (it ends the capture)."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._side()):
                out = fn(*args)
        finally:
            if collecting:
                gc.enable()
        return graph, out

    def host_buffer(self, nbytes: int) -> np.ndarray:
        """A pinned host byte buffer of at least ``nbytes``, free to write
        (the last copy out of it has finished)."""
        if self._copied is not None:
            self._copied.synchronize()
        if self._host is None or self._host.numel() < nbytes:
            self._host = torch.empty(max(nbytes, 4096), dtype=torch.uint8,
                                     pin_memory=True)
            self._host_np = self._host.numpy()
        return self._host_np

    def copy_in(self, dst: torch.Tensor) -> None:
        """One copy of the host buffer's first ``dst.numel()`` bytes into
        ``dst`` on the current stream."""
        dst.copy_(self._host[:dst.numel()], non_blocking=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record()


@dataclasses.dataclass
class _Entry:
    """One captured shape."""
    inputs: Optional[torch.Tensor]   # the static inputs' bytes
    offsets: Tuple[int, ...]         # each host array's offset in them
    views: Tuple[torch.Tensor, ...]  # the static inputs
    ptrs: Tuple[int, ...]            # the captured device tensors'
    graph: object = None
    outputs: object = None           # the static outputs
    # (tally, what one replay adds to it)
    tallies: List[Tuple[Dict, Dict]] = dataclasses.field(
        default_factory=list)


class CapturedFn(ShapeCountingFn):
    """Wraps ``fn(*fixed, *inputs)``, whose first ``fixed`` arguments are
    device tensor trees (a paged call's params, kpools and vpools: 3) and
    the rest host arrays (numpy): one captured graph per argument-shape
    key (``metrics._shape_key``), replayed on every later call of that
    key; see the module docstring.

    ``counter`` counts the distinct keys (``_cache_size()``), as jit counts
    compilations: on the card each is one capture.  ``replays`` counts the
    replays, ``capture_s`` holds each capture's (warm-up s, capture s).
    ``graphs`` (:class:`CudaGraphs`) decides whether calls are captured:
    on CPU tensors they are not."""

    def __init__(self, fn, counter: Counter, graphs: CudaGraphs,
                 fixed: int = 3):
        super().__init__(fn, counter)
        self.graphs = graphs
        self.fixed = fixed
        self.entries: Dict[tuple, _Entry] = {}
        self.replays = 0
        self.capture_s: List[Tuple[float, float]] = []

    def _eager(self) -> bool:
        return bool(_DISABLED[0]) or not self.graphs.captures()

    def __call__(self, *args):
        fixed, host = args[:self.fixed], args[self.fixed:]
        if self._eager():
            self._count((args, {}))
            dev = self.graphs.device
            return self.fn(*fixed, *(torch.from_numpy(a).to(dev)
                                     for a in host))
        tr = self.graphs.tracer
        # the span opens before the shape key, which decides its name
        with tr.span("graph/replay") as sp:
            key = self._count((args, {}))
            entry = self.entries.get(key)
            if entry is not None:
                return self._replay(entry, fixed, host)
            out = self._capture(key, fixed, host)
            if tr.enabled:
                warm, cap = self.capture_s[-1]
                sp.name = "graph/capture"
                sp.args = {"warmup_s": warm, "capture_s": cap}
            return out

    def replays_call(self, *args) -> bool:
        """Whether a call with ``args`` would replay a captured graph."""
        return not self._eager() and _shape_key((args, {})) in self.entries

    def _stage(self, entry: _Entry, host) -> None:
        """The host arrays into the entry's static inputs: one copy."""
        if not host:
            return
        buf = self.graphs.host_buffer(entry.inputs.numel())
        for a, off in zip(host, entry.offsets):
            a = np.ascontiguousarray(a)
            buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        self.graphs.copy_in(entry.inputs)

    def _capture(self, key, fixed, host):
        """The first call of ``key``: the step for real, then its capture.
        Returns the real step's outputs."""
        g = self.graphs
        offsets, n = [], 0
        for a in host:                   # 16-byte aligned slices
            offsets.append(n)
            n += -(-a.nbytes // 16) * 16
        inputs = (torch.empty(max(n, 16), dtype=torch.uint8, device=g.device)
                  if host else None)
        views = tuple(inputs[o:o + a.nbytes].view(torch.from_numpy(a).dtype)
                      .view(a.shape) for a, o in zip(host, offsets))
        entry = _Entry(inputs, tuple(offsets), views, _ptrs(fixed))
        self._stage(entry, host)
        t0 = time.perf_counter()
        out = g.run(self.fn, fixed + views)
        t1 = time.perf_counter()
        marks = [(t, dict(t)) for t in TALLIES]
        try:
            entry.graph, entry.outputs = g.capture(self.fn, fixed + views)
        except RuntimeError as e:
            raise RuntimeError(f"capturing the call at argument shapes {key} "
                               f"failed") from e
        finally:
            # the capture ran no kernel: its counts are a replay's
            for t, m in marks:
                entry.tallies.append((t, {k: v - m.get(k, 0)
                                          for k, v in t.items()
                                          if v != m.get(k, 0)}))
                t.clear()
                t.update(m)
        self.capture_s.append((t1 - t0, time.perf_counter() - t1))
        self.entries[key] = entry
        return out

    def _replay(self, entry: _Entry, fixed, host):
        if _ptrs(fixed) != entry.ptrs:
            raise RuntimeError(
                "the device tensors passed in are not the ones this shape "
                "was captured on: its graph reads and writes the captured "
                "ones")
        self._stage(entry, host)
        entry.graph.replay()
        for t, add in entry.tallies:
            for k, v in add.items():
                t[k] = t.get(k, 0) + v
        self.replays += 1
        return entry.outputs
