"""Primary-worker parallelism: the hierarchical sigma* search of paper §4.1.

Search pipeline (Fig 4):

  1. **Instance grouping** — enumerate DP degrees; device types are evenly
     divided across instances; configurations whose KV capacity cannot host
     the decoding of the request distribution R are filtered out.
  2. **Layer -> stage mapping** — within an instance, devices of one class
     form a unified pipeline stage; layers are assigned to minimize
     C_p = max_s (stage compute cost) under perfect latency scaling.
  3. **Delta-exclusion** — devices are removed one by one, lowest-end class
     first, while  C_p(sigma - k) / C_p(sigma) <= 1 + Delta  (Delta = 0.05).
     Removed devices become Attention workers (a pool shared by every
     instance).
  4. **Intra-stage TP x PP search** — each unified stage explores tensor /
     pipeline splits of its devices, scored by the full HexGen-style
     C_comm + C_comp model; the cheapest expansion wins.

A copy of the framework-free ``repro.core.parallelizer`` (the port imports
nothing of ``repro``); the parity tests hold its plans equal to the
reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterSpec, Device, DEVICE_CLASSES
from repro_torch.core.costmodel import (DENSE_EFF, ModelProfile, StageConfig,
                                        dense_flops_layer,
                                        pipeline_iteration_time)


@dataclasses.dataclass(frozen=True)
class RequestDistribution:
    """R: what the Parallelizer knows about the workload (paper Eq 1)."""

    batch: int = 25              # concurrent decode batch per instance-cluster
    prefill_len: int = 512       # average prompt length
    decode_ctx: int = 1024       # average live context during decode
    avg_output_len: int = 128    # expected tokens generated per request

    def scaled(self, factor: float) -> "RequestDistribution":
        return dataclasses.replace(self, batch=max(1, int(self.batch * factor)))


@dataclasses.dataclass
class InstancePlan:
    """One DP serving instance: an ordered PP chain of stages."""

    stages: List[StageConfig]

    @property
    def devices(self) -> List[Device]:
        return [d for s in self.stages for d in s.devices]


@dataclasses.dataclass
class ParallelPlan:
    """sigma*: the full primary-worker parallelization."""

    instances: List[InstancePlan]
    attention_workers: List[Device]
    cost: float                    # modeled per-request latency (s)
    search_seconds: float = 0.0

    @property
    def primary_workers(self) -> List[Device]:
        return [d for inst in self.instances for d in inst.devices]

    def summary(self) -> str:
        lines = []
        for i, inst in enumerate(self.instances):
            seg = " -> ".join(
                f"{s.cls.name} x{s.tp} ({s.n_layers}L)" for s in inst.stages)
            lines.append(f"instance[{i}]: {seg}")
        pool = ", ".join(d.name for d in self.attention_workers) or "(none)"
        lines.append(f"attention pool: {pool}")
        lines.append(f"modeled cost: {self.cost*1e3:.2f} ms")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Step 2 helpers: layer mapping + C_p
# ---------------------------------------------------------------------------

def _class_power(cls_name: str) -> float:
    c = DEVICE_CLASSES[cls_name]
    return c.dense_tflops * DENSE_EFF[cls_name]


def assign_layers(groups: Sequence[Tuple[str, int]], n_layers: int
                  ) -> List[int]:
    """Assign layers to unified stages proportionally to aggregate power,
    largest-remainder rounding; every non-empty stage gets >= 1 layer."""
    powers = [_class_power(name) * count for name, count in groups]
    total = sum(powers) or 1.0
    raw = [n_layers * p / total for p in powers]
    base = [max(1, int(x)) for x in raw]
    # fix rounding to sum exactly
    while sum(base) > n_layers:
        i = max(range(len(base)), key=lambda j: base[j] - raw[j])
        if base[i] > 1:
            base[i] -= 1
        else:  # all at 1 already; drop from the largest stage
            i = max(range(len(base)), key=lambda j: base[j])
            base[i] -= 1
    rem = n_layers - sum(base)
    order = sorted(range(len(base)), key=lambda j: raw[j] - base[j], reverse=True)
    for j in range(rem):
        base[order[j % len(order)]] += 1
    return base


def c_p(groups: Sequence[Tuple[str, int]], p: ModelProfile,
        r: RequestDistribution, n_layers_map: Optional[List[int]] = None
        ) -> float:
    """Max per-stage dense compute cost under *perfect latency scaling*
    (paper: no communication term, fractional layer split allowed in this
    inner objective — integrality only matters at final materialization).

    With a continuous layer split proportional to power, every stage cost is
    equal, so C_p = total work / total power; an explicit integral map can
    be passed to score a materialized plan instead.
    """
    if not groups:
        return float("inf")
    fl_dec = dense_flops_layer(p, r.batch) * p.n_layers
    fl_pre = (dense_flops_layer(p, r.prefill_len) * p.n_layers
              / max(1, r.avg_output_len))
    if n_layers_map is None:
        total_power = sum(_class_power(name) * count * 1e12
                          for name, count in groups)
        return (fl_dec + fl_pre) / total_power
    worst = 0.0
    per_layer = (fl_dec + fl_pre) / p.n_layers
    for (name, count), L in zip(groups, n_layers_map):
        power = _class_power(name) * count * 1e12
        worst = max(worst, per_layer * L / power)
    return worst


# ---------------------------------------------------------------------------
# Step 1+3+4: the full hierarchical search
# ---------------------------------------------------------------------------

def _even_dp_choices(counts: Dict[str, int]) -> List[int]:
    """DP degrees that divide every class count (even division, paper)."""
    out = []
    max_dp = max(counts.values())
    for dp in range(1, max_dp + 1):
        if all(c % dp == 0 for c in counts.values()):
            out.append(dp)
    return out


def _kv_capacity_ok(groups: Sequence[Tuple[str, int]], pool_mem_gb: float,
                    p: ModelProfile, r: RequestDistribution,
                    layers: Sequence[int]) -> bool:
    """Filter: enough free memory for the decode KV of R (paper step 1).

    Primary devices hold weights for their layers; the rest of their memory
    plus the attention pool holds KV cache.
    """
    need = r.batch * r.decode_ctx * p.kv_bytes_per_token()
    free = pool_mem_gb * 1e9
    for (name, count), L in zip(groups, layers):
        cls = DEVICE_CLASSES[name]
        weights = sum(p.layer_dense_params(i) for i in range(L)) * p.dtype_bytes
        per_dev_free = cls.mem_gb * 1e9 * 0.9 - weights / count
        free += max(0.0, per_dev_free) * count
    return free >= need


def _expand_stage_tp_pp(devices: Sequence[Device], n_layers: int,
                        p: ModelProfile, cluster: ClusterSpec,
                        r: RequestDistribution) -> List[StageConfig]:
    """Step 4: split one unified stage into tp x pp, pick cheapest."""
    n = len(devices)
    best: Optional[List[StageConfig]] = None
    best_cost = float("inf")
    for pp in range(1, n + 1):
        if n % pp or n_layers < pp:
            continue
        tp = n // pp
        per = [n_layers // pp + (1 if i < n_layers % pp else 0)
               for i in range(pp)]
        stages = []
        for i in range(pp):
            devs = tuple(devices[i * tp:(i + 1) * tp])
            stages.append(StageConfig(devs, per[i]))
        cost = (pipeline_iteration_time(stages, p, cluster, r.batch, 1.0,
                                        r.decode_ctx, "decode",
                                        include_logits=False)
                + pipeline_iteration_time(stages, p, cluster, 1.0,
                                          r.prefill_len, r.prefill_len,
                                          "prefill", include_logits=False)
                / max(1, r.avg_output_len))
        if cost < best_cost:
            best_cost, best = cost, stages
    assert best is not None
    return best


def search(cluster: ClusterSpec, p: ModelProfile, r: RequestDistribution,
           delta: float = 0.05) -> ParallelPlan:
    """Run the full hierarchical search; returns sigma* as a ParallelPlan."""
    t0 = time.perf_counter()
    by_cls = cluster.by_class()
    counts = {k: len(v) for k, v in by_cls.items()}
    class_order_low_first = cluster.classes_by_power()

    best_plan: Optional[ParallelPlan] = None
    for dp in _even_dp_choices(counts):
        inst_counts = {k: c // dp for k, c in counts.items()}
        r_inst = r.scaled(1.0 / dp)

        # -- step 2: unified stages, high-end first in the chain -----------
        groups: List[Tuple[str, int]] = [
            (name, inst_counts[name])
            for name in reversed(class_order_low_first) if inst_counts[name] > 0
        ]

        # -- step 3: Delta-exclusion, lowest-end first ----------------------
        excluded: Dict[str, int] = {}
        while True:
            cur = c_p(groups, p, r_inst)
            removed = False
            for name in class_order_low_first:
                idx = next((i for i, g in enumerate(groups) if g[0] == name),
                           None)
                if idx is None:
                    continue
                g2 = [list(g) for g in groups]
                g2[idx][1] -= 1
                g2 = [tuple(g) for g in g2 if g[1] > 0]
                if not g2:
                    continue
                if c_p(g2, p, r_inst) / cur <= 1.0 + delta:
                    groups = g2
                    excluded[name] = excluded.get(name, 0) + 1
                    removed = True
                    break
            if not removed:
                break

        layers = assign_layers(groups, p.n_layers)

        # attention pool = everything not selected, across all dp instances
        sel_counts = {name: cnt for name, cnt in groups}
        pool_mem = sum((inst_counts[name] - sel_counts.get(name, 0))
                       * DEVICE_CLASSES[name].mem_gb
                       for name in inst_counts) * dp
        if not _kv_capacity_ok(groups, pool_mem / dp, p, r_inst, layers):
            continue

        # -- step 4: expand each unified stage via TP x PP ------------------
        # materialize concrete devices per instance
        cursor = {k: 0 for k in by_cls}
        instances: List[InstancePlan] = []
        used_ids = set()
        for inst_idx in range(dp):
            stages: List[StageConfig] = []
            for (name, cnt), L in zip(groups, layers):
                devs = by_cls[name][cursor[name]:cursor[name] + cnt]
                cursor[name] += cnt
                used_ids.update(d.device_id for d in devs)
                stages.extend(_expand_stage_tp_pp(devs, L, p, cluster, r_inst))
            instances.append(InstancePlan(stages))
            # skip over the excluded devices of this instance
            for name, cnt in inst_counts.items():
                extra = cnt - sel_counts.get(name, 0)
                cursor[name] += extra

        pool = [d for d in cluster.devices if d.device_id not in used_ids]
        cost = _plan_cost(instances, p, cluster, r_inst)
        if best_plan is None or cost < best_plan.cost:
            best_plan = ParallelPlan(instances, pool, cost)

    assert best_plan is not None, "no feasible parallel plan"
    best_plan.search_seconds = time.perf_counter() - t0
    return best_plan


def _plan_cost(instances: List[InstancePlan], p: ModelProfile,
               cluster: ClusterSpec, r: RequestDistribution) -> float:
    """Per-request latency estimate for a DP set of instances (max over
    instances, since load is balanced across them)."""
    worst = 0.0
    for inst in instances:
        dec = pipeline_iteration_time(inst.stages, p, cluster, r.batch, 1.0,
                                      r.decode_ctx, "decode")
        pre = pipeline_iteration_time(inst.stages, p, cluster, 1.0,
                                      r.prefill_len, r.prefill_len, "prefill")
        worst = max(worst, pre + r.avg_output_len * dec)
    return worst
