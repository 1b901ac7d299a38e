"""Iteration-level continuous-batching simulator (drives Figs 8-16).

The loop mirrors Orca-style continuous batching: at every iteration the
system (a) admits queued requests if KV capacity and the system's own
admission logic allow, running their prefill, then (b) executes one decode
iteration for the running batch.  The clock advances by modelled times from
``core/costmodel``; requests record TTFT / TPOT / end-to-end latency.

A copy of the framework-free ``repro.sim.des`` on the port's ``Tracer``.
The clock is the cost model's: simulated seconds of the modelled device
classes, not a measurement of the device this runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.sim.systems import BaseSystem, LiveRequest
from repro_torch.sim.workloads import TraceRequest
from repro_torch.telemetry import Tracer


@dataclasses.dataclass
class SimResult:
    system: str
    workload: str
    rate: float
    finished: List[LiveRequest]
    duration: float
    timeline: List[Dict]                 # sampled state (Fig 14)
    # simulated-clock span record: every decode iteration emits one
    # "attention" and one "mlp" span on track "sim" tagged with the rids
    # it covered — the single source of module-latency numbers (Fig 13)
    tracer: Optional[Tracer] = None

    # ---- metrics ------------------------------------------------------------
    def _lat(self, r: LiveRequest) -> float:
        return r.finish - r.trace.arrival

    def normalized_latency(self) -> float:
        """Mean end-to-end latency per output token (Figs 8-10 y-axis)."""
        vals = [self._lat(r) / max(1, r.trace.output_len)
                for r in self.finished if r.finish is not None]
        return float(np.mean(vals)) if vals else float("nan")

    def p95_ttft(self) -> float:
        vals = [r.ttft for r in self.finished if r.ttft is not None]
        return float(np.percentile(vals, 95)) if vals else float("nan")

    def p95_tpot(self) -> float:
        vals = []
        for r in self.finished:
            if r.finish is None or r.ttft is None or r.trace.output_len < 2:
                continue
            vals.append((self._lat(r) - r.ttft) / (r.trace.output_len - 1))
        return float(np.percentile(vals, 95)) if vals else float("nan")

    def mean_tpot(self) -> float:
        vals = []
        for r in self.finished:
            if r.finish is None or r.ttft is None or r.trace.output_len < 2:
                continue
            vals.append((self._lat(r) - r.ttft) / (r.trace.output_len - 1))
        return float(np.mean(vals)) if vals else float("nan")

    @property
    def served(self) -> List[LiveRequest]:
        return [r for r in self.finished if r.finish is not None]

    def p95_module(self, which: str) -> float:
        """P95 per-token module latency ("attention" or "mlp"), rebuilt
        from the tracer's simulated-clock spans: each iteration span names
        the rids it covered, so per-request totals fall out of the span
        record instead of per-request accumulator fields."""
        if self.tracer is None:
            return float("nan")
        per_rid: Dict[int, float] = {}
        for sp in self.tracer.spans(which, track="sim"):
            for rid in sp.args["rids"]:
                per_rid[rid] = per_rid.get(rid, 0.0) + sp.dur
        vals = [per_rid.get(r.rid, 0.0) / max(1, r.trace.output_len)
                for r in self.served]
        return float(np.percentile(vals, 95)) if vals else float("nan")

    def throughput(self) -> float:
        if not self.served:
            return 0.0
        return len(self.served) / self.duration


def simulate(system: BaseSystem, trace: List[TraceRequest],
             workload: str = "", rate: float = 0.0,
             max_sim_seconds: float = 3600.0,
             sample_every: int = 20,
             tracer: Optional[Tracer] = None) -> SimResult:
    # module spans are the simulator's only per-request module accounting,
    # so the tracer is always on here (ring sized for hour-long runs)
    tracer = tracer or Tracer(enabled=True, capacity=1 << 18)
    queue: List[LiveRequest] = [LiveRequest(t) for t in trace]
    queue.sort(key=lambda r: r.trace.arrival)
    clock = 0.0
    pending: List[LiveRequest] = []      # arrived, waiting for admission
    i_next = 0
    timeline: List[Dict] = []
    finished: List[LiveRequest] = []
    it = 0

    while (i_next < len(queue) or pending or system.running) \
            and clock < max_sim_seconds:
        # move arrivals whose time has come
        while i_next < len(queue) and queue[i_next].trace.arrival <= clock:
            pending.append(queue[i_next])
            i_next += 1
        if not pending and not system.running and i_next < len(queue):
            clock = queue[i_next].trace.arrival
            continue

        # admission + prefill (batched per iteration like Sarathi/Orca)
        admitted = []
        for req in list(pending):
            if not system.can_admit(req.trace):
                if not system.running and len(pending) == len([req]) \
                        and req is pending[0] \
                        and req.trace.prompt_len + req.trace.output_len \
                        > system.kv_capacity_tokens():
                    # unservable even on an empty system: drop it
                    pending.remove(req)
                    req.finish = None
                    finished.append(req)
                    continue
                break
            if not system.on_admit(req):
                break
            pending.remove(req)
            clock += system.prefill_time(req.trace.prompt_len)
            req.prefilled = True
            req.generated = 1           # prefill emits the first token
            req.ttft = clock - req.trace.arrival
            system.running.append(req)
            admitted.append(req)
            system.on_token(req)
        if not system.running and not admitted and pending:
            # capacity deadlock with work outstanding: jump to next arrival
            # or give the system a maintenance tick to free space
            system.maintenance()
            if not system.running:
                if i_next < len(queue):
                    clock = max(clock + 1e-3,
                                queue[i_next].trace.arrival)
                else:
                    # nothing can ever be admitted again
                    for req in pending:
                        req.finish = None
                        finished.append(req)
                    pending.clear()
            continue

        # one decode iteration
        if system.running:
            total, attn_t, dense_t = system.decode_iteration()
            rids = tuple(r.rid for r in system.running)
            tracer.add_span("attention", clock, attn_t, track="sim",
                            args={"rids": rids})
            tracer.add_span("mlp", clock + attn_t, dense_t, track="sim",
                            args={"rids": rids})
            clock += total
            for req in list(system.running):
                req.generated += 1
                system.on_token(req)
                if req.done:
                    req.finish = clock
                    system.running.remove(req)
                    system.on_finish(req)
                    finished.append(req)
        system.maintenance()
        # preempted requests (memory pressure) go back to the head of the
        # pending queue for re-admission (their decode restarts)
        for req in getattr(system, "preempted", []):
            pending.insert(0, req)
        if hasattr(system, "preempted"):
            system.preempted = []

        if it % sample_every == 0:
            snap = {"t": clock, "running": len(system.running),
                    "pending": len(pending)}
            if hasattr(system, "workers"):
                for w in system.workers:
                    snap[f"heads_{w.device_id}"] = w.heads
                    snap[f"cache_{w.device_id}"] = w.cache_bytes
            timeline.append(snap)
        it += 1

    return SimResult(system.name, workload, rate, finished, clock, timeline,
                     tracer)
