"""Serving-system models for the cluster simulator (paper §7 baselines).

All three systems run the SAME iteration-level continuous-batching loop
(sim/des.py); they differ exactly where the paper says they differ:

  HetisSystem     — primary-worker parallelism from the real Parallelizer
                    sigma* search; decode Attention dispatched head-wise by
                    the real Dispatcher LP across primary + pool devices;
                    Θ-re-dispatching and device-local eviction (§5.3).
  HexgenSystem    — static asymmetric TP/PP over ALL devices (type-uniform
                    pipeline stages, layers split by compute power); decode
                    attention stays with the owning stage; KV capacity is
                    bottlenecked by the weakest stage (Fig 1b).
  SplitwiseSystem — phase disaggregation: prefill instance on the high-end
                    devices, decode instance on the low-end chain; model
                    weights replicated on both; per-request KV migration
                    prefill -> decode over the LAN (§2.3, Fig 1a).

Timing comes from core/costmodel (Table 1 / Fig 2 calibration); KV
accounting from ModelProfile.kv_bytes_per_token().

A copy of the framework-free ``repro.sim.systems`` on the port's own
dispatcher, parallelizer and profiler (the port imports nothing of
``repro``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec, Device, DEVICE_CLASSES
from repro_torch.core.costmodel import (ModelProfile, StageConfig,
                                        attn_module_time, dense_module_time,
                                        logits_time, pipeline_iteration_time)
from repro_torch.core.dispatcher import (AttnRequest, WorkerState,
                                         apply_placement,
                                         current_attention_time, dispatch_lp,
                                         grow_context,
                                         handle_memory_exhaustion,
                                         maybe_rebalance, release_request)
from repro_torch.core.parallelizer import (ParallelPlan, RequestDistribution,
                                           assign_layers, search)
from repro_torch.core.profiler import (analytic_attention_model,
                                       analytic_transfer_model)
from repro_torch.sim.workloads import TraceRequest


@dataclasses.dataclass
class LiveRequest:
    trace: TraceRequest
    generated: int = 0
    prefilled: bool = False
    ttft: Optional[float] = None
    finish: Optional[float] = None

    @property
    def rid(self) -> int:
        return self.trace.rid

    @property
    def ctx(self) -> int:
        return self.trace.prompt_len + self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.trace.output_len


class BaseSystem:
    """Iteration-level serving model.  Subclasses define capacity,
    prefill_time, decode_iteration_time, and admission bookkeeping."""

    name = "base"

    def __init__(self, profile: ModelProfile, cluster: ClusterSpec):
        self.profile = profile
        self.cluster = cluster
        self.running: List[LiveRequest] = []

    # capacity ---------------------------------------------------------------
    def kv_capacity_tokens(self) -> float:
        raise NotImplementedError

    def kv_used_tokens(self) -> float:
        return sum(r.ctx for r in self.running)

    def can_admit(self, req: TraceRequest) -> bool:
        return (self.kv_used_tokens() + req.prompt_len + req.output_len
                <= self.kv_capacity_tokens())

    # timing -------------------------------------------------------------------
    def prefill_time(self, prompt_len: int) -> float:
        raise NotImplementedError

    def decode_iteration(self) -> Tuple[float, float, float]:
        """(total, attn_part, dense_part) for one token across the batch."""
        raise NotImplementedError

    # hooks ----------------------------------------------------------------------
    def on_admit(self, req: LiveRequest) -> bool:
        return True

    def on_token(self, req: LiveRequest) -> None:
        pass

    def on_finish(self, req: LiveRequest) -> None:
        pass

    def maintenance(self) -> None:
        pass


def _weights_bytes_per_device(profile: ModelProfile, n_layers: int, tp: int
                              ) -> float:
    per_layer = profile.layer_dense_params() * profile.dtype_bytes
    return per_layer * n_layers / tp


# ---------------------------------------------------------------------------
# Hetis
# ---------------------------------------------------------------------------

class HetisSystem(BaseSystem):
    name = "hetis"

    def __init__(self, profile: ModelProfile, cluster: ClusterSpec,
                 r: Optional[RequestDistribution] = None, theta: float = 0.5,
                 use_redispatch: bool = True, optimistic_admission: bool = False,
                 model_error: float = 0.0, seed: int = 0):
        super().__init__(profile, cluster)
        self.theta = theta
        self.use_redispatch = use_redispatch
        self.optimistic_admission = optimistic_admission
        self.preempted: List[LiveRequest] = []
        r = r or RequestDistribution(batch=24, prefill_len=512,
                                     decode_ctx=800, avg_output_len=200)
        self.plan: ParallelPlan = search(cluster, profile, r)
        inst = self.plan.instances[0]
        self.stages = inst.stages

        rng = np.random.default_rng(seed)
        self.workers: List[WorkerState] = []
        primary_ids = {d.device_id for d in self.plan.primary_workers}
        for d in cluster.devices:
            attn_m = analytic_attention_model(d.cls, profile)
            xfer = None if d.device_id in primary_ids else \
                analytic_transfer_model(d.cls.inter_link_gbps)
            if model_error:
                attn_m = attn_m.perturbed(model_error, rng)
                xfer = xfer.perturbed(model_error, rng) if xfer else None
            cap = self._device_cache_bytes(d)
            self.workers.append(WorkerState(d.device_id, attn_m, xfer, cap))
        self.attn_reqs: Dict[int, AttnRequest] = {}
        self.migrated_bytes = 0.0
        self.redispatches = 0
        self.evictions = 0

    def _device_cache_bytes(self, d: Device) -> float:
        primary_ids = {x.device_id for x in self.plan.primary_workers}
        mem = d.cls.mem_gb * 1e9 * 0.9
        if d.device_id in primary_ids:
            for st in self.stages:
                if d in st.devices:
                    mem -= _weights_bytes_per_device(self.profile,
                                                     st.n_layers, st.tp)
        return max(0.0, mem)

    def kv_capacity_tokens(self) -> float:
        total = sum(w.capacity_bytes for w in self.workers if w.alive)
        return total / self.profile.kv_bytes_per_token()

    def can_admit(self, req) -> bool:
        if self.optimistic_admission:
            # vLLM-style: reserve only the prompt; growth handled by the
            # §5.3 memory-balance path (re-dispatch or LIFO preemption)
            return (self.kv_used_tokens() + req.prompt_len
                    <= self.kv_capacity_tokens())
        return super().can_admit(req)

    def on_admit(self, req: LiveRequest) -> bool:
        ar = AttnRequest(rid=req.rid, ctx_len=req.trace.prompt_len,
                         n_heads=self.profile.n_heads,
                         group_ratio=self.profile.gqa_ratio,
                         head_dim=self.profile.head_dim,
                         dtype_bytes=self.profile.dtype_bytes,
                         arrival=req.trace.arrival)
        pl = dispatch_lp(self.workers, [ar])
        if pl is None:
            return False
        apply_placement(self.workers, [ar], pl)
        self.attn_reqs[req.rid] = ar
        return True

    def on_token(self, req: LiveRequest) -> None:
        ar = self.attn_reqs.get(req.rid)
        if ar is not None:
            grow_context(self.workers, ar, 1)
        # §5.3 memory balance: a device over capacity triggers either
        # re-dispatching (cluster has aggregate space) or device-local LIFO
        # preemption; without re-dispatch, plain LIFO preemption (baseline)
        for w in self.workers:
            if not w.alive or w.cache_bytes <= w.capacity_bytes:
                continue
            live = list(self.attn_reqs.values())
            if self.use_redispatch:
                decisions, evicted = handle_memory_exhaustion(
                    self.workers, live, w.device_id, theta=self.theta)
                self.redispatches += len(decisions)
                self.migrated_bytes += sum(d.migrated_bytes
                                           for d in decisions)
            else:
                local = sorted((a for a in live
                                if w.device_id in a.placement),
                               key=lambda a: a.arrival, reverse=True)
                evicted = local[:1]
                for a in evicted:
                    release_request(self.workers, a)
            for a in evicted:
                self.evictions += 1
                victim = next((q for q in self.running if q.rid == a.rid),
                              None)
                self.attn_reqs.pop(a.rid, None)
                if victim is not None:
                    self.running.remove(victim)
                    # preemption recomputes: progress lost (swap-out)
                    victim.generated = 0
                    victim.prefilled = False
                    self.preempted.append(victim)

    def on_finish(self, req: LiveRequest) -> None:
        ar = self.attn_reqs.pop(req.rid, None)
        if ar is not None:
            release_request(self.workers, ar)

    _maint_tick = 0

    def maintenance(self) -> None:
        if not self.use_redispatch:
            return
        # the deviation check solves the ideal-time LP; amortize it over a
        # few iterations (the paper checks periodically, not per token)
        self._maint_tick += 1
        if self._maint_tick % 5:
            return
        d = maybe_rebalance(self.workers, list(self.attn_reqs.values()),
                            theta=self.theta)
        if d is not None:
            self.migrated_bytes += d.migrated_bytes
            self.redispatches += 1

    def prefill_time(self, prompt_len: int) -> float:
        # prefill runs on the primary pipeline only (I1)
        return pipeline_iteration_time(self.stages, self.profile,
                                       self.cluster, 1.0, prompt_len,
                                       prompt_len, "prefill")

    def decode_iteration(self) -> Tuple[float, float, float]:
        if not self.running:
            return 1e-4, 0.0, 0.0
        batch = len(self.running)
        dense = 0.0
        for st in self.stages:
            dense += dense_module_time(st.cls, self.profile, batch,
                                       tp=st.tp, n_layers=st.n_layers)
        dense += logits_time(self.stages[-1].cls, self.profile, batch,
                             tp=self.stages[-1].tp)
        attn = current_attention_time(
            self.workers, self.profile.gqa_ratio, self.profile.head_dim,
            self.profile.dtype_bytes)
        return dense + attn, attn, dense

    # fault tolerance hook (beyond-paper): drop a device, re-dispatch
    def fail_device(self, device_id: int) -> int:
        from repro_torch.core.dispatcher import handle_worker_failure
        decisions, evicted = handle_worker_failure(
            self.workers, list(self.attn_reqs.values()), device_id)
        self.redispatches += len(decisions)
        self.evictions += len(evicted)
        return len(evicted)


# ---------------------------------------------------------------------------
# HexGen
# ---------------------------------------------------------------------------

class HexgenSystem(BaseSystem):
    name = "hexgen"

    def __init__(self, profile: ModelProfile, cluster: ClusterSpec):
        super().__init__(profile, cluster)
        # type-uniform pipeline stages over ALL devices, layers by power
        by_cls = cluster.by_class()
        names = cluster.classes_by_power(reverse=True)
        groups = [(n, len(by_cls[n])) for n in names]
        layers = assign_layers(groups, profile.n_layers)
        self.stages = [StageConfig(tuple(by_cls[n]), L)
                       for (n, _), L in zip(groups, layers)]

    def kv_capacity_tokens(self) -> float:
        # bottleneck: the stage with the least free memory per hosted layer
        # (Fig 1b: 3090 exhausts while A100 has spare)
        worst = float("inf")
        for st in self.stages:
            free = st.cls.mem_gb * 1e9 * 0.9 - _weights_bytes_per_device(
                self.profile, st.n_layers, st.tp)
            free = max(0.0, free) * st.tp
            per_token = (self.profile.kv_bytes_per_token_layer()
                         * st.n_layers)
            worst = min(worst, free / per_token)
        return worst

    def prefill_time(self, prompt_len: int) -> float:
        return pipeline_iteration_time(self.stages, self.profile,
                                       self.cluster, 1.0, prompt_len,
                                       prompt_len, "prefill")

    def decode_iteration(self) -> Tuple[float, float, float]:
        if not self.running:
            return 1e-4, 0.0, 0.0
        batch = len(self.running)
        ctx = float(np.mean([r.ctx for r in self.running]))
        dense = attn = 0.0
        for st in self.stages:
            dense += dense_module_time(st.cls, self.profile, batch,
                                       tp=st.tp, n_layers=st.n_layers)
            attn += attn_module_time(st.cls, self.profile, batch, ctx,
                                     tp=st.tp, n_layers=st.n_layers)
        dense += logits_time(self.stages[-1].cls, self.profile, batch,
                             tp=self.stages[-1].tp)
        return dense + attn, attn, dense


# ---------------------------------------------------------------------------
# Splitwise
# ---------------------------------------------------------------------------

class SplitwiseSystem(BaseSystem):
    name = "splitwise"

    def __init__(self, profile: ModelProfile, cluster: ClusterSpec):
        super().__init__(profile, cluster)
        by_cls = cluster.by_class()
        names = cluster.classes_by_power(reverse=True)
        # prefill instance: all devices of the highest-end class, TP
        self.prefill_stage = StageConfig(tuple(by_cls[names[0]]),
                                         profile.n_layers)
        # decode instance: PP chain over the remaining classes; layers split
        # proportionally to memory (a compute split cannot even fit weights)
        rest = names[1:]
        mems = [(n, len(by_cls[n]) * DEVICE_CLASSES[n].mem_gb) for n in rest]
        total_mem = sum(m for _, m in mems) or 1.0
        layers, acc = [], 0
        for i, (n, m) in enumerate(mems):
            L = (profile.n_layers - acc if i == len(mems) - 1
                 else max(1, round(profile.n_layers * m / total_mem)))
            layers.append(L)
            acc += L
        self.decode_stages = [StageConfig(tuple(by_cls[n]), L)
                              for (n, _), L in zip(mems, layers)]
        # DESIGN §8: a second fp16 replica cannot fit the low-end pool for
        # 70B-class models; per the Splitwise paper's quantization-friendly
        # setting the decode replica is fp8.
        dense_b = sum(profile.layer_dense_params(i)
                      for i in range(profile.n_layers)) * profile.dtype_bytes
        pool_b = sum(len(by_cls[n]) * DEVICE_CLASSES[n].mem_gb * 1e9 * 0.7
                     for n, _ in mems)
        self.decode_weight_scale = 0.5 if dense_b > pool_b else 1.0
        self.migration_s_per_token = (
            profile.kv_bytes_per_token()
            / (DEVICE_CLASSES[names[0]].inter_link_gbps * 1e9))

    def kv_capacity_tokens(self) -> float:
        # decode instance only; every decode device holds a full weight copy
        # of its layers (phase split = extra replicas, Fig 1a)
        worst = float("inf")
        for st in self.decode_stages:
            w = _weights_bytes_per_device(self.profile, st.n_layers, st.tp) \
                * self.decode_weight_scale
            free = max(0.0, st.cls.mem_gb * 1e9 * 0.9 - w) * st.tp
            per_token = (self.profile.kv_bytes_per_token_layer()
                         * st.n_layers)
            worst = min(worst, free / per_token)
        return worst

    def prefill_time(self, prompt_len: int) -> float:
        t = pipeline_iteration_time([self.prefill_stage], self.profile,
                                    self.cluster, 1.0, prompt_len,
                                    prompt_len, "prefill")
        # KV migration to the decode instance rides the LAN per request
        return t + self.migration_s_per_token * prompt_len

    def decode_iteration(self) -> Tuple[float, float, float]:
        if not self.running:
            return 1e-4, 0.0, 0.0
        batch = len(self.running)
        ctx = float(np.mean([r.ctx for r in self.running]))
        dense = attn = 0.0
        for st in self.decode_stages:
            dense += dense_module_time(st.cls, self.profile, batch,
                                       tp=st.tp, n_layers=st.n_layers)
            attn += attn_module_time(st.cls, self.profile, batch, ctx,
                                     tp=st.tp, n_layers=st.n_layers)
        dense += logits_time(self.decode_stages[-1].cls, self.profile,
                             batch, tp=self.decode_stages[-1].tp)
        return dense + attn, attn, dense
