"""One run of one cell: set-up, warm-up, the measured window, the
metrics, and the comparison that decides ``correct``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads`` (its config,
traffic and chips) and a file ``bench/cells/<cell>.json`` (the cluster's
roles, the engine's settings, the pool sizes, the load, the warm-up, the
trace and the check).  The config is ``bench/configs/<config>.json``, the
traffic ``bench/traffic/<mix>.json``, each metric a reader
``bench/metrics/<metric>.py``.

The program is ``repro_torch``'s ``InferenceEngine``: the benchmark
builds it on weights it makes from the seed, submits requests when they
are due (an open loop) or keeps its queue full (a backlog), calls
``step()``, and stamps every served token with the host clock at the
``step()`` that returned it (each step ends in a copy of its tokens to the
host, so the device has finished it).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench import check, stats, traffic
from bench.weights import make_params

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_READERS: Dict[str, object] = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict                # bench/configs/<config>.json
    mix: Dict                   # bench/traffic/<mix>.json
    spec: Dict                  # bench/cells/<cell>.json
    chips: int
    end_to_end: List[Dict]      # the metrics this cell reports
    per_layer: List[Dict]

    @classmethod
    def named(cls, name: str) -> "Cell":
        bench = load_json(ROOT / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
        return cls(name, load_json(ROOT / conf["file"]),
                   traffic.load_mix(entry["traffic"]),
                   load_json(BENCH / "cells" / f"{name}.json"),
                   int(entry["chips"]), mine(bench["end_to_end"]),
                   mine(bench["per_layer"]))


def reader(metric: str):
    """The module that reads ``metric``: ``bench/metrics/<metric>.py``,
    else the file of its name up to the first dot (``mfu.online`` ->
    ``mfu.py``)."""
    if metric not in _READERS:
        path = BENCH / "metrics" / f"{metric}.py"
        if not path.exists():
            path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[metric] = mod
    return _READERS[metric]


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` of a config file."""
    from repro_torch.models.config import ModelConfig
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "d_ff", "vocab_size", "qk_norm", "rope_theta", "norm_eps",
            "tie_embeddings", "dtype", "n_experts", "top_k", "moe_d_ff",
            "capacity_factor")
    return ModelConfig(name=cfg["name"], family=cfg["family"],
                       **{k: cfg[k] for k in keys if k in cfg})


def build_engine(cell: Cell, mcfg, params, device, telemetry: bool):
    """The engine of the cell: its cluster and roles, its settings, and
    its pool shards sized by ``pool_gb`` (GB of K/V pages a device)."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    spec = cell.spec
    cluster = ClusterSpec.build([tuple(d) for d in spec["cluster"]])
    # the engine gives a device min(cache bytes / page bytes / kv heads,
    # max_batch * kv heads * pages of max_seq) pages of all layers' K/V
    cache = {int(k): gb * mcfg.n_kv_heads for k, gb in
             spec["pool_gb"].items()}
    ecfg = EngineConfig(**spec["engine"], cache_gb_per_device=cache,
                        telemetry=telemetry, trace_capacity=1 << 20)
    return InferenceEngine(mcfg, params, cluster, spec["primary"],
                           spec["pool"], ecfg, device=device)


@dataclasses.dataclass
class Served:
    req: object
    due: Optional[float]         # host time the request was due (open loop)
    first: Optional[float] = None
    last: Optional[float] = None
    seen: int = 0


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    rows: Optional[List] = None  # (start, n, logits taken), traced runs
    batch: int = 0               # the call's padded rows and chunk width
    chunk: int = 0


class LoadGen:
    """Submits requests, steps the engine and stamps served tokens."""

    def __init__(self, eng, trace_rows: bool):
        self.eng = eng
        self.trace_rows = trace_rows
        self.served: Dict[int, Served] = {}
        self.gaps: List = []          # (end, seconds) between two tokens
        self.steps: List[Step] = []
        self.spans: List = []         # its own host spans (idle waits)
        self.submitted = 0
        self._fin = 0
        self._pp: Dict[int, int] = {}

    def submit(self, job, due: Optional[float]) -> None:
        from repro_torch.serving.request import Request
        req = Request(rid=self.submitted, prompt=job.prompt,
                      max_new_tokens=job.max_new)
        self.served[req.rid] = Served(req, due)
        self._pp[req.rid] = 0
        self.submitted += 1
        self.eng.submit(req)

    def busy(self) -> bool:
        e = self.eng
        return bool(e.queue or e.running or e.prefilling)

    def step(self) -> None:
        e = self.eng
        dec = ([r.ctx_len for r in e.running if not r.done]
               if self.trace_rows else None)
        t0 = time.perf_counter()
        e.step()
        t1 = time.perf_counter()
        rec = Step(t0, t1)
        if self.trace_rows:
            self._rows(rec, dec)
        self.steps.append(rec)
        self._harvest(t1)

    def _rows(self, rec: Step, dec: List[int]) -> None:
        """The fused call's real rows, from public request state: decode
        rows (one token at ctx - 1) of the requests running before the
        step, and the prefill chunks by which ``prefill_pos`` moved."""
        e = self.eng
        rows = [(c - 1, 1, True) for c in dec]
        for r in (e.prefilling + e.running + e.finished[self._fin:]):
            old = self._pp.get(r.rid, 0)
            if r.prefill_pos > old:
                rows.append((old, r.prefill_pos - old,
                             r not in e.prefilling))
            self._pp[r.rid] = r.prefill_pos
        if rows:
            pow2 = lambda n: 1 << (n - 1).bit_length()
            rec.rows, rec.batch = rows, pow2(len(rows))
            rec.chunk = pow2(max(n for _, n, _ in rows))

    def _harvest(self, t: float) -> None:
        e = self.eng
        for r in e.running + e.finished[self._fin:]:
            s = self.served[r.rid]
            for _ in range(len(r.output) - s.seen):
                if s.seen == 0:
                    s.first = t
                else:
                    self.gaps.append((t, t - s.last))
                s.last = t
                s.seen += 1
        self._fin = len(e.finished)

    def idle_until(self, t: float) -> None:
        t0 = time.perf_counter()
        if t > t0:
            time.sleep(t - t0)
            self.spans.append(("bench.wait_for_arrival", t0,
                               time.perf_counter()))


def _captures(eng) -> int:
    return (eng.fused_compile_count() + eng.prefill_compile_count()
            + eng.decode_compile_count())


class Phase:
    """Drives the engine until ``until`` or until ``settled()``: an open
    loop submits each job when due (its arrival after ``origin``), a
    backlog keeps ``max_batch`` requests waiting."""

    def __init__(self, drv: LoadGen, cell: Cell, jobs, origin: float):
        self.drv, self.cell, self.origin = drv, cell, origin
        self.open = cell.mix["arrivals"] == "poisson"
        self.jobs = jobs
        self.i = 0

    def run(self, until: float, settled=None, on_step=None) -> None:
        drv, eng = self.drv, self.drv.eng
        mb = eng.ecfg.max_batch
        while True:
            now = time.perf_counter()
            if now >= until or (settled is not None and settled(now)):
                return
            if self.open:
                while (self.i < len(self.jobs) and self.origin
                       + self.jobs[self.i].arrival <= now):
                    job = self.jobs[self.i]
                    drv.submit(job, self.origin + job.arrival)
                    self.i += 1
            else:
                while len(eng.queue) < mb:
                    drv.submit(next(self.jobs), None)
            if drv.busy():
                drv.step()
                if on_step is not None:
                    on_step()
            else:
                nxt = (self.origin + self.jobs[self.i].arrival
                       if self.i < len(self.jobs) else until)
                drv.idle_until(min(nxt, until))


def process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        import os
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


@dataclasses.dataclass
class Window:
    """What the metric readers read."""
    cell: Cell
    t0: float
    close: float
    setup_s: float
    due: List                     # (due, first token) of requests due
    gaps: List                    # (end, seconds) ending in the window
    tokens: int                   # served in the window
    steps: List[Step]
    counters: Dict[str, float]
    spans: List                   # engine tracer spans in the window
    device: Optional[Dict] = None  # DeviceTrace.read, traced runs
    traced_steps: List[Step] = dataclasses.field(default_factory=list)


def warm_up(drv: LoadGen, cell: Cell, seed: int, seconds: float,
            vocab: int) -> None:
    """The cell's own traffic on a stream of the seed that the window
    never sends (its token ids; the schedule is the mix's).  An open loop
    replays the window's schedule ``replays`` times, so the engine has met
    the shapes of a window that starts on a loaded engine; a backlog runs
    until no shape has been captured for ``settle_s`` seconds (at least
    ``min_s``, at most ``max_s``)."""
    w = cell.spec["warmup"]
    if cell.mix["arrivals"] == "poisson":
        jobs = traffic.open_loop(cell.mix, cell.spec["rate_per_s"], seconds,
                                 seed, traffic.WARM, vocab)
        first = jobs[0]
    else:
        jobs = traffic.backlog(cell.mix, seed, traffic.WARM, vocab)
        first = next(jobs)
    # the kernels' libraries build (on a checkout's first run) and load at
    # the first call: serve one short request before the timed warm-up,
    # so that a build does not stall it
    drv.submit(dataclasses.replace(first, max_new=2), None)
    while drv.busy():
        drv.step()
    t0 = time.perf_counter()
    if cell.mix["arrivals"] == "poisson":
        for _ in range(w["replays"]):
            start = time.perf_counter()
            Phase(drv, cell, jobs, start).run(start + seconds)
    else:
        last = [_captures(drv.eng), t0]

        def settled(now):
            n = _captures(drv.eng)
            if n != last[0]:
                last[:] = [n, now]
            return (now - t0 >= w["min_s"]
                    and now - last[1] >= w["settle_s"])

        Phase(drv, cell, jobs, t0).run(t0 + w["max_s"], settled)
    log(f"warm-up: {time.perf_counter() - t0:.1f} s, {drv.submitted} "
        f"requests, {_captures(drv.eng)} shapes captured, "
        f"{len(drv.eng.running) + len(drv.eng.prefilling)} in the batch, "
        f"{len(drv.eng.queue)} queued")


def measure(cell: Cell, eng, drv: LoadGen, seed: int, seconds: float,
            trace: bool, t_process: float, vocab: int) -> Window:
    """The window: ``seconds`` of the cell's traffic on ``seed``, on the
    warm engine; with ``trace`` the profiler over its last ``trace["s"]``
    seconds (the profiler's stop, which collects the trace, comes after
    the window has closed)."""
    gc.collect()
    gc.freeze()
    n_steps0 = len(drv.steps)
    counters0 = (eng.registry.counter("fastpath/gather_d2d_bytes").value,
                 _captures(eng))
    fin0 = drv.submitted - len(eng.queue)
    if trace:
        eng.tracer.reset()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    if cell.mix["arrivals"] == "poisson":
        jobs = traffic.open_loop(cell.mix, cell.spec["rate_per_s"], seconds,
                                 seed, traffic.WINDOW, vocab)
    else:
        jobs = traffic.backlog(cell.mix, seed, traffic.WINDOW, vocab)
    first_rid = drv.submitted
    phase = Phase(drv, cell, jobs, t0)
    dtrace = None
    traced = (0, 0)
    if trace and eng.device.type == "cuda":
        from bench.trace import DeviceTrace
        dtrace = DeviceTrace()
        phase.run(t0 + max(0.0, seconds - cell.spec["trace"]["s"]))
        i0 = len(drv.steps)
        dtrace.start()
    phase.run(t0 + seconds)
    close = time.perf_counter()
    if dtrace is not None:
        dtrace.stop()
        traced = (i0, len(drv.steps))
    gc.unfreeze()
    due = [(s.due, s.first) for rid, s in drv.served.items()
           if rid >= first_rid and s.due is not None and s.due <= close]
    steps = drv.steps[n_steps0:]
    counters = {
        "gather_d2d_bytes": eng.registry.counter(
            "fastpath/gather_d2d_bytes").value - counters0[0],
        "captures": _captures(eng) - counters0[1],
        "admitted": (drv.submitted - len(eng.queue)) - fin0,
    }
    spans = []
    if trace:
        spans = [sp for sp in eng.tracer.spans(track="main")
                 if sp.ts >= t0]
    w = Window(cell, t0, close, setup_s, due,
               [g for g in drv.gaps if t0 <= g[0] <= close],
               _tokens_between(drv, t0, close), steps, counters, spans)
    if dtrace is not None:
        host = ([(sp.name, sp.ts, sp.ts + sp.dur) for sp in spans]
                + [sp for sp in drv.spans if sp[1] >= t0])
        w.device = dtrace.read(host)
        w.traced_steps = drv.steps[traced[0]:traced[1]]
    return w


def _tokens_between(drv: LoadGen, t0: float, t1: float) -> int:
    """Tokens served at steps that returned in [t0, t1]: the first tokens
    and the ends of the gaps between tokens."""
    firsts = sum(1 for s in drv.served.values()
                 if s.first is not None and t0 <= s.first <= t1)
    return firsts + sum(1 for end, _ in drv.gaps if t0 <= end <= t1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return f"card: {out}"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def setup(cell: Cell, seed: int, seconds: float, device, trace: bool):
    """(weights, engine, load generator) of a run with a window of ``seconds``,
    the engine warm."""
    cfg = cell.config
    params = make_params(cfg, seed, device)
    eng = build_engine(cell, model_config(cfg), params, device,
                       telemetry=trace)
    drv = LoadGen(eng, trace_rows=trace)
    if trace and eng.device.type == "cuda":
        from bench.trace import DeviceTrace      # the profiler's first start
        d = DeviceTrace()
        d.start()
        d.stop()
    warm_up(drv, cell, seed, seconds, cfg["vocab_size"])
    return params, eng, drv


def judge(cell: Cell, params, served: List, seed: int, device) -> Dict:
    """The comparison that decides ``correct``: each number beside its
    limit."""
    limits = cell.spec["check"]
    picked = check.sample(served, seed, limits["min_tokens"],
                          limits["min_requests"])
    ref = check.load_reference(cell.config["reference"])
    t_ref = time.perf_counter()
    gaps, _ = check.gaps(ref, cell.config, params, picked, device)
    n_tok = int(gaps.size)
    placed = sum(1 for r in picked if len(r.placement) > 1)
    log(f"check: {len(picked)} requests ({placed} with heads on more than "
        f"one device), {n_tok} served tokens, reference "
        f"{time.perf_counter() - t_ref:.1f} s")
    return {"gap_max": {"value": float(gaps.max()) if n_tok else
                        float("inf"), "limit": limits["gap_max"]},
            "served_tokens": {"value": n_tok, "limit": limits["min_tokens"]},
            "requests": {"value": len(picked),
                         "limit": limits["min_requests"]}}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Dict:
    """One run of ``cell``: the result's fields, in the order of
    the result line, with ``checks`` last."""
    cuda = torch.device(device).type == "cuda"
    params, eng, drv = setup(cell, seed, seconds, device, trace)
    w = measure(cell, eng, drv, seed, seconds, trace, t_process,
                cell.config["vocab_size"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"]).read(w)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = (len(w.due) if cell.mix["arrivals"] == "poisson"
                 else int(w.counters["admitted"]))
    log(f"window: {w.close - w.t0:.3f} s, {len(w.steps)} steps, "
        f"{w.tokens} tokens, {attempted} requests attempted, "
        f"{w.counters['captures']} shapes captured in it, peak "
        f"{peak / 1e9:.2f} GB")
    waits = [stats.censored(f, d, w.close) for d, f in w.due]
    gaps = [g for _, g in w.gaps]
    pct = lambda xs, q: round(1e3 * (stats.percentile(xs, q) or 0), 2)
    log(f"window: ttft ms p50 {pct(waits, 50)} p75 {pct(waits, 75)} p90 "
        f"{pct(waits, 90)} over {len(waits)}; gap ms p50 {pct(gaps, 50)} "
        f"p90 {pct(gaps, 90)} p95 {pct(gaps, 95)} p99 {pct(gaps, 99)} over "
        f"{len(gaps)}; {w.tokens / (w.close - w.t0):.1f} tokens/s")
    served = [s.req for s in drv.served.values() if s.req.output]
    # the program's state goes before the reference runs
    del eng, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge(cell, params, served, seed, device)
    correct = all(c["value"] <= c["limit"] if name == "gap_max"
                  else c["value"] >= c["limit"] for name, c in checks.items())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if w.device is not None:
        dev["busy_s"] = w.device["busy_s"]
        dev["window_s"] = w.device["window_s"]
        top = sorted(w.device["kernels"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [[k[:120], s] for k, s in top[:10]],
                            "idle_gaps": w.device["idle_gaps"]}
    out["checks"] = checks
    return out
