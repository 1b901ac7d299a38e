"""The engine's host spans on the CPU: every stretch of host time in a
``step`` lies in a leaf span named for its work (``engine.HOST_SPANS``
beside the reference's ``admit`` / call / ``rebalance`` spans), in the
fused and the split schedule, with the paged calls eager and with them
captured and replayed through the stand-in for the card's graphs
(``test_torch_graphs.RecordingGraphs``); the call clock's events sit
around the exchange of every paged call.  ``tests/test_torch_cuda.py``
reads the events on the card."""

import re
import statistics

import pytest

torch = pytest.importorskip("torch")

from test_torch_graphs import RecordingGraphs
from repro_torch.configs import get_config
from repro_torch.core.cluster import ClusterSpec
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, InferenceEngine, Request
from repro_torch.serving import engine as tengine
from repro_torch.serving import graphs
from repro_torch.weights import init_params

CFG = get_config("qwen3-14b").reduced(vocab_size=128)
PARAMS = init_params(CFG, 0, device="cpu")
CALLS = {"fused": ("fused_step",), "split": ("prefill_chunk",
                                             "paged_decode")}
# a step: admit, then per paged call pack / call / commit, then the
# balance spans around an optional rebalance
STEP = {"fused": r"admit,(pack,fused_step,commit,)?balance,"
                 r"(rebalance,)?balance,",
        "split": r"admit,(pack,prefill_chunk,commit,)?"
                 r"(pack,paged_decode,commit,)?balance,(rebalance,)?"
                 r"balance,"}


def serve(mode, captured, telemetry=True):
    """The reduced engine (an A100 primary, a 3090 pool shard) serving 5
    requests under ``mode``; with ``captured`` its paged calls go through
    the stand-in graphs, which record on the engine's tracer."""
    eng = InferenceEngine(
        CFG, PARAMS, ClusterSpec.build([("A100", 1), ("3090", 1)]),
        primary_ids=[0], pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=8, max_seq=64, page_size=16,
                                prefill_chunk=16, step_mode=mode,
                                telemetry=telemetry),
        device="cpu")
    if captured:
        stand_in = RecordingGraphs()
        stand_in.tracer = eng.tracer
        for w in (eng._fused_fn, eng._paged_fn, eng._chunk_fn):
            w.graphs = stand_in
    for i in range(5):
        eng.submit(Request(rid=i, prompt=[(7 * i + 3 * k) % CFG.vocab_size
                                          for k in range(9 + 6 * i)],
                           max_new_tokens=6))
    assert eng.run_until_drained(200)
    return eng


@pytest.fixture(scope="module", params=[("fused", False), ("fused", True),
                                        ("split", False), ("split", True)],
                ids=["fused-eager", "fused-captured", "split-eager",
                     "split-captured"])
def served(request):
    mode, captured = request.param
    return mode, captured, serve(mode, captured)


def tree(spans):
    """Each main-track span with its children, by nesting: a span's parent
    is the innermost span one depth up that holds it."""
    spans = sorted(spans, key=lambda sp: (sp.ts, sp.depth))
    kids = {id(sp): [] for sp in spans}
    parent = {}
    stack = []
    for sp in spans:
        while stack and stack[-1].depth >= sp.depth:
            stack.pop()
        if stack:
            assert stack[-1].depth == sp.depth - 1, sp
            assert sp.ts + sp.dur <= stack[-1].ts + stack[-1].dur + 1e-9
            parent[id(sp)] = stack[-1]
            kids[id(stack[-1])].append(sp)
        else:
            assert sp.depth == 0, sp
        stack.append(sp)
    return parent, kids


def test_leaf_spans_name_each_part_of_the_step(served):
    mode, captured, eng = served
    spans = eng.tracer.spans(track="main")
    parent, kids = tree(spans)
    calls = set(CALLS[mode])
    for sp in spans:
        up = parent.get(id(sp))
        if sp.name == "step":
            assert up is None
            names = "".join(k.name + "," for k in kids[id(sp)])
            assert re.fullmatch(STEP[mode], names), names
        elif sp.name in calls:
            assert up.name == "step"
            inner = [k.name for k in kids[id(sp)]]
            if captured:
                assert inner in (["graph/replay", "wait"],
                                 ["graph/capture", "wait"]), inner
            else:
                assert inner == ["wait"], inner
            assert "device_ms" not in sp.args       # no call clock here
        elif sp.name in ("graph/replay", "graph/capture", "wait"):
            assert up.name in calls and not kids[id(sp)]
        else:
            assert up.name == "step" and not kids[id(sp)], sp.name
    names = {sp.name for sp in spans}
    assert not any(n.startswith("fused/") for n in names)
    assert names - {"step", "admit", "rebalance"} - calls \
        == set(tengine.HOST_SPANS) - (
            set() if captured else {"graph/replay", "graph/capture"})


def test_each_step_is_covered_by_its_leaf_spans(served):
    """A step's self time (its duration less its children's) is at most 5 %
    of it, as a median over the steps (about 1 % here).  A step of a few
    ms that the OS preempts between two spans may read more, but no step
    leaves a quarter of itself uncovered."""
    _, _, eng = served
    spans = eng.tracer.spans(track="main")
    _, kids = tree(spans)
    shares = [1.0 - sum(k.dur for k in kids[id(st)]) / st.dur
              for st in spans if st.name == "step"]
    assert len(shares) == eng.metrics["steps"]
    assert statistics.median(shares) <= 0.05
    assert max(shares) <= 0.25, sorted(shares)[-3:]


def test_span_args(served):
    """``pack`` carries its rows and gather lanes (none where the step had
    no row to pack), one pack with rows a call; the call span keeps the
    reference's args; ``graph/capture`` carries the capture's seconds."""
    mode, captured, eng = served
    main = eng.tracer.spans(track="main")
    packs = [sp for sp in main if sp.name == "pack"]
    assert all(set(sp.args) in (set(), {"rows", "gather_lanes"})
               for sp in packs)
    full = [sp.args for sp in packs if sp.args]
    calls = [sp.args for sp in main if sp.name in CALLS[mode]]
    assert len(full) == len(calls) == eng.metrics["model_calls"]
    # spans are recorded as they close: each call's pack closed before it
    for note, args in zip(full, calls):
        assert 0 < note["rows"] <= args["batch"]
        assert note["gather_lanes"] >= 0
        if mode == "fused":
            assert note["rows"] >= args["decode_rows"]
    assert any(note["gather_lanes"] > 0 for note in full)
    if captured:
        wrappers = (eng._fused_fn, eng._paged_fn, eng._chunk_fn)
        caps = [sp.args for sp in main if sp.name == "graph/capture"]
        assert sorted((a["warmup_s"], a["capture_s"]) for a in caps) \
            == sorted(c for w in wrappers for c in w.capture_s)
        assert eng.tracer.count("graph/replay") \
            == sum(w.replays for w in wrappers) > 0


def test_untraced_engine_records_nothing():
    eng = serve("fused", captured=True, telemetry=False)
    assert len(eng.tracer) == 0 and eng._clock is None
    assert eng._graphs.tracer is eng.tracer
    # a wrapper's graphs trace nothing unless their owner gives a tracer
    assert not graphs.CudaGraphs("cpu").tracer.enabled


class Mark:
    def __init__(self, log, i):
        self.log, self.i = log, i

    def record(self):
        self.log.append(f"mark{self.i}")


@pytest.mark.parametrize("lanes", [0, 3])
def test_call_marks_bracket_the_exchange(monkeypatch, lanes):
    """``_on_anchor`` records its four marks at the start, after the
    gather, before the write-back and at the end, with or without lanes."""
    log = []
    for name in ("_pool_exchange_in", "_pool_exchange_out"):
        orig = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _o=orig, _n=name:
                            (log.append(_n), _o(*a))[1])
    pools = {0: torch.zeros(2, 8, 4), 1: torch.ones(2, 8, 4)}
    vpools = {k: v.clone() for k, v in pools.items()}
    lane = torch.zeros(lanes, dtype=torch.int32)
    ex = (lane + 1, lane, lane, lane + 1, lane, lane)
    logits, _, _ = T._on_anchor(pools, vpools, 0, 7, ex,
                                lambda ak, av: log.append("step") or ak[0],
                                [Mark(log, i) for i in range(4)])
    assert log == ["mark0", "_pool_exchange_in", "mark1", "step", "mark2",
                   "_pool_exchange_out", "mark3"]
    assert T._on_anchor(pools, vpools, 0, 7, ex, lambda ak, av: ak[0])[0] \
        .equal(logits)


class Elapsed:
    """An event stand-in: its time in ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_call_clock_reads_the_call_and_its_exchange():
    clock = graphs.CallClock.__new__(graphs.CallClock)
    clock.events = tuple(Elapsed(t) for t in (1.0, 1.25, 9.5, 10.0))
    assert clock.read() == {"device_ms": 9.0, "exchange_ms": 0.75}


def test_a_capture_holds_the_cyclic_collector_off(monkeypatch):
    """No cyclic collection runs inside a capture (one could free a dead
    owner's graph, which ends the capture on the card); the collector's
    state is restored after, also when the capture raises."""
    import contextlib
    import gc
    seen = []

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, stream=None):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(graphs.CudaGraphs, "_side", lambda self: None)
    g = graphs.CudaGraphs("cpu")
    assert g.capture(lambda x: seen.append(gc.isenabled()) or x, (3,)) \
        == ("graph", 3)
    assert seen == [False] and gc.isenabled()

    def fails():
        raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError):
        g.capture(fails, ())
    assert gc.isenabled()
    gc.disable()
    try:
        g.capture(lambda: None, ())
        assert not gc.isenabled()
    finally:
        gc.enable()
