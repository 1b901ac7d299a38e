"""The engine's captured paged calls (``repro_torch.serving.graphs``) on
the CPU: one entry per argument-shape key, the host arrays staged into the
static inputs, the launch counts a replay must add, ``disable_capture()``,
params or pools of other storage refused, and the reduced engines, fused
and split, in lockstep with the reference's while every paged call is
captured and replayed.

CUDA graphs exist only on the card, so here a test-only stand-in
(``RecordingGraphs``) takes the card's side: its capture runs the function
(as the Python of a real capture runs) and records it, its replay runs it
again on the static inputs with every tally held (a real replay runs no
Python) and writes the results into the static outputs.  The card tests
(``tests/test_torch_cuda.py``) capture real graphs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import (TCFG, assert_same, make_pair, submit_both)
from repro_torch.kernels.paged_attention import ops
from repro_torch.serving import graphs
from repro_torch.telemetry import MetricsRegistry


def _copy_leaves(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_leaves(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_leaves(a, b)
    elif isinstance(dst, torch.Tensor) and dst is not src:
        dst.copy_(src)


class _Graph:
    def __init__(self, owner, fn, args, outputs):
        self.owner, self.fn, self.args, self.outputs = (owner, fn, args,
                                                        outputs)

    def replay(self):
        self.owner.log.append("replay")
        marks = [dict(t) for t in graphs.TALLIES]
        new = self.fn(*self.args)
        for t, m in zip(graphs.TALLIES, marks):
            t.clear()
            t.update(m)
        _copy_leaves(self.outputs, new)


class RecordingGraphs(graphs.CudaGraphs):
    """The card's side of a capture, stood in for on the CPU (see the
    module docstring); ``log`` records run / capture / replay."""

    def __init__(self, fail=False):
        super().__init__("cpu")
        self.log, self.fail = [], fail

    def captures(self):
        return True

    def run(self, fn, args):
        self.log.append("run")
        return fn(*args)

    def capture(self, fn, args):
        self.log.append("capture")
        out = fn(*args)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return _Graph(self, fn, args, out), out

    def host_buffer(self, nbytes):
        if self._host is None or self._host.size < nbytes:
            self._host = np.zeros(nbytes, np.uint8)
        return self._host

    def copy_in(self, dst):
        dst.copy_(torch.from_numpy(self._host[:dst.numel()]))


def toy(params, kpools, vpools, *inputs):
    """A paged call's form: (logits, pools); bumps the launch counts as
    a kernel wrapper does, writes the pools in place."""
    ops.LAUNCHES["paged_prefill_attention"] += 2
    ops.PREFILL_TILE_LAUNCHES["wgmma"] += 2
    total = sum(t.double().sum() for t in inputs) + params["w"].sum()
    kpools[0][0] += 1.0
    return total.reshape(1) * torch.ones(2, dtype=torch.float64), \
        kpools, vpools


def fixed():
    return ({"w": torch.ones(3)}, {0: torch.zeros(2, 4)},
            {0: torch.zeros(2, 4)})


def host(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100, (n, 3)).astype(np.int32),
            np.zeros((0,), np.int32),
            rng.integers(0, 100, (n,)).astype(np.int32),
            rng.integers(0, 100, (2, n, 5)).astype(np.int32))


def captured(fn=toy, stand_in=None):
    reg = MetricsRegistry()
    return (graphs.CapturedFn(fn, reg.counter("jit/recompiles"),
                              stand_in or RecordingGraphs()), reg)


@pytest.fixture
def launches():
    """The kernels' launch counts from 0, as a run sets them."""
    saved = [dict(t) for t in graphs.TALLIES]
    for t in graphs.TALLIES:
        for k in t:
            t[k] = 0
    yield ops.LAUNCHES, ops.PREFILL_TILE_LAUNCHES
    for t, s in zip(graphs.TALLIES, saved):
        t.clear()
        t.update(s)


def test_one_entry_per_shape_key_replayed_on_the_same_key(launches):
    f, reg = captured()
    p, kp, vp = fixed()
    seen = set()
    for n, seed in ((2, 0), (2, 1), (4, 0), (2, 2), (4, 3)):
        assert f.replays_call(p, kp, vp, *host(n)) == (n in seen)
        seen.add(n)
        f(p, kp, vp, *host(n, seed))
    assert f.graphs.log == ["run", "capture", "replay", "run", "capture",
                            "replay", "replay"]
    assert len(f.entries) == f._cache_size() == 2
    assert f.replays == 3
    assert reg.snapshot()["jit/recompiles"] == 2.0
    assert [len(s) for s in f.capture_s] == [2, 2]


def test_host_arrays_reach_the_static_inputs(launches):
    """Every array, whatever its size (an empty exchange lane array too),
    lands in its 16-byte aligned slice of the entry's one input buffer,
    and a replay computes on the new values."""
    f, _ = captured()
    p, kp, vp = fixed()
    f(p, kp, vp, *host(3, 0))
    (entry,) = f.entries.values()
    assert all(o % 16 == 0 for o in entry.offsets)
    for seed in (1, 2):
        arrays = host(3, seed)
        out, _, _ = f(p, kp, vp, *arrays)
        for view, a in zip(entry.views, arrays):
            assert view.dtype == torch.int32 and view.shape == a.shape
            assert np.array_equal(view.numpy(), a)
        want = sum(int(a.astype(np.int64).sum()) for a in arrays) + 3
        assert out.tolist() == [want, want]
        assert out is entry.outputs[0]      # the static output


def test_replays_add_the_launches_the_capture_counted(launches):
    """The first call of a shape counts its real run only (the capture
    launches nothing); each replay adds what the capture counted, to
    every tally registered while the shape was captured."""
    pa, tiles = launches
    extra = {}
    graphs.TALLIES.append(extra)

    def fn(*args):
        extra["calls"] = extra.get("calls", 0) + 1
        return toy(*args)
    try:
        f, _ = captured(fn)
        p, kp, vp = fixed()
        f(p, kp, vp, *host(2))
        assert pa["paged_prefill_attention"] == 2 and tiles["wgmma"] == 2
        assert extra == {"calls": 1}
        for i in range(3):
            f(p, kp, vp, *host(2, i))
        assert pa["paged_prefill_attention"] == 8 and tiles["wgmma"] == 8
        assert extra == {"calls": 4}
        assert pa["paged_attention"] == 0 and tiles["tma"] == 0
        (entry,) = f.entries.values()
        adds = {id(t): a for t, a in entry.tallies}
        assert adds[id(pa)] == {"paged_prefill_attention": 2}
        assert adds[id(tiles)] == {"wgmma": 2}
        assert adds[id(extra)] == {"calls": 1}
    finally:
        graphs.TALLIES.remove(extra)


def test_disable_capture_runs_every_call_eagerly(launches):
    pa, _ = launches
    f, reg = captured()
    p, kp, vp = fixed()
    with graphs.disable_capture():
        with graphs.disable_capture():
            f(p, kp, vp, *host(2))
        assert not f.replays_call(p, kp, vp, *host(2))
        f(p, kp, vp, *host(2, 1))
    assert f.graphs.log == [] and not f.entries and f.replays == 0
    assert pa["paged_prefill_attention"] == 4
    assert f._cache_size() == 1 and reg.snapshot()["jit/recompiles"] == 1.0
    # outside the block the shape is captured at its next call
    f(p, kp, vp, *host(2))
    assert f.graphs.log == ["run", "capture"]
    assert f.replays_call(p, kp, vp, *host(2))


def test_cpu_tensors_run_eagerly(launches):
    calls = []

    def fn(*args):
        calls.append([type(a) for a in args[3:]])
        return toy(*args)
    f, _ = captured(fn, graphs.CudaGraphs("cpu"))
    p, kp, vp = fixed()
    for _ in range(3):
        out, _, _ = f(p, kp, vp, *host(2))
    assert not f.entries and f.replays == 0 and len(calls) == 3
    assert all(t is torch.Tensor for c in calls for t in c)
    assert kp[0][0, 0] == 3.0          # every call ran


def test_params_or_pools_of_other_storage_raise(launches):
    f, _ = captured()
    p, kp, vp = fixed()
    f(p, kp, vp, *host(2))
    f({"w": p["w"]}, dict(kp), dict(vp), *host(2))   # the same tensors
    for args in (({"w": p["w"].clone()}, kp, vp),
                 (p, {0: kp[0].clone()}, vp),
                 (p, kp, {0: torch.zeros(2, 4)})):
        with pytest.raises(RuntimeError, match="captured on"):
            f(*args, *host(2))
    assert f.replays == 1


def test_a_failing_capture_raises_and_keeps_no_entry(launches):
    pa, _ = launches
    f, _ = captured(stand_in=RecordingGraphs(fail=True))
    p, kp, vp = fixed()
    with pytest.raises(RuntimeError, match="capturing the call"):
        f(p, kp, vp, *host(2))
    assert not f.entries
    assert pa["paged_prefill_attention"] == 2     # the real run's only
    with pytest.raises(RuntimeError, match="capturing the call"):
        f(p, kp, vp, *host(2))


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_captured_engine_in_lockstep_with_the_reference(mode):
    """The reduced engine with every paged call captured (the stand-in)
    and replayed: the reference's tokens, counters, pool tables and clock
    after every step, through a migration and a preemption (the pools
    written in place under the captured graphs); one entry per distinct
    shape, replays on the rest."""
    j, t = make_pair(step_mode=mode)
    stand_in = RecordingGraphs()
    wrappers = (t._fused_fn, t._paged_fn, t._chunk_fn)
    for w in wrappers:
        w.graphs = stand_in
    submit_both(j, t, 5, seed=3, lo=6, hi=30, max_new=8)
    for _ in range(3):
        j.step()
        t.step()
    assert_same(j, t)
    movers = [r.rid for r in j.running][:2]
    for eng in (j, t):
        for rid in movers:
            eng._apply_migration(rid, {1: TCFG.n_heads})
    victims = [r.rid for r in j.running if r.output][:1]
    for eng in (j, t):
        for rid in victims:
            eng._preempt(next(r for r in eng.running if r.rid == rid))
    assert_same(j, t)
    for _ in range(400):
        if not (j.queue or j.running or j.prefilling):
            break
        j.step()
        t.step()
        assert_same(j, t)
    assert len(t.finished) == 5
    t.kv.check_invariants()
    calls = sum(w._cache_size() + w.replays for w in wrappers)
    assert calls == t.metrics["model_calls"]
    assert stand_in.log.count("capture") == sum(len(w.entries)
                                                 for w in wrappers)
    assert stand_in.log.count("replay") == sum(w.replays
                                               for w in wrappers) > 0
    if mode == "fused":
        assert t.fused_compile_count() == j.fused_compile_count()
        assert len(t._fused_fn.entries) <= t.fused_bucket_count()
    else:
        assert t.decode_compile_count() == j.decode_compile_count()
        assert t.prefill_compile_count() == j.prefill_compile_count()
        assert len(t._paged_fn.entries) <= t.bucket_count()
        assert len(t._chunk_fn.entries) <= t.prefill_bucket_count()
