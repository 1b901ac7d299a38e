"""Fault tolerance & elasticity (DESIGN §7): failure handling for serving
and elastic re-planning for both phases.

Serving-side recovery reuses the paper's own machinery:
  * attention-worker loss  -> Dispatcher.handle_worker_failure re-places the
    lost heads among survivors (cache recomputed or restored);
  * primary-worker loss    -> Parallelizer re-searches sigma* on the
    surviving devices and the engine restarts from its checkpoint;
  * straggler              -> observed per-device times feed back into the
    (a_i, b_i, c_i) coefficients, so slow devices organically shed heads at
    the next dispatch — Θ bounds the damage window.

A copy of the framework-free ``repro.distributed.fault_tolerance`` (the
port imports nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.costmodel import ModelProfile
from repro_torch.core.dispatcher import WorkerState
from repro_torch.core.parallelizer import (ParallelPlan, RequestDistribution,
                                           search)


@dataclasses.dataclass
class ElasticEvent:
    kind: str                 # "fail" | "join" | "straggler"
    device_id: int
    detail: str = ""


class ElasticController:
    """Tracks cluster membership and re-plans when it changes."""

    def __init__(self, cluster: ClusterSpec, profile: ModelProfile,
                 r: RequestDistribution):
        self.cluster = cluster
        self.profile = profile
        self.r = r
        self.dead: set = set()
        self.events: List[ElasticEvent] = []
        self.plan: ParallelPlan = search(cluster, profile, r)

    def alive_cluster(self) -> ClusterSpec:
        return self.cluster.remove(sorted(self.dead))

    def fail(self, device_id: int) -> ParallelPlan:
        self.dead.add(device_id)
        self.events.append(ElasticEvent("fail", device_id))
        primary_ids = {d.device_id for d in self.plan.primary_workers}
        if device_id in primary_ids:
            # primary loss: re-search sigma* over survivors (engine restarts
            # from checkpoint; decode state is re-prefilled)
            self.plan = search(self.alive_cluster(), self.profile, self.r)
            self.events.append(ElasticEvent(
                "fail", device_id, "primary -> re-searched sigma*"))
        return self.plan

    def join(self, device_id: int) -> ParallelPlan:
        if device_id in self.dead:
            self.dead.remove(device_id)
            self.events.append(ElasticEvent("join", device_id))
            self.plan = search(self.alive_cluster(), self.profile, self.r)
        return self.plan

    def observe_step(self, worker: WorkerState, predicted_s: float,
                     observed_s: float, alpha: float = 0.2) -> None:
        """Straggler mitigation: scale the worker's Eq (3) coefficients by
        the observed/predicted ratio (EWMA), so dispatch shifts load away."""
        if predicted_s <= 0:
            return
        ratio = observed_s / predicted_s
        if ratio > 1.5:
            self.events.append(ElasticEvent(
                "straggler", worker.device_id, f"ratio={ratio:.2f}"))
        blend = (1 - alpha) + alpha * ratio
        worker.attn.a *= blend
        worker.attn.b *= blend
