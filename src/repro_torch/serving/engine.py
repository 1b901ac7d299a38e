"""Hetis inference engine: continuous batching + dynamic head dispatching,
on PyTorch.

The paper's control loop, as in ``repro.serving.engine``:

  admit   — new requests get head placements from the Dispatcher LP (Eq 7)
            and page chains on the assigned devices' pool shards;
  step    — ``step_mode="fused"`` (the default): ONE model call per
            iteration (``transformer.sharded_fused_step``) whose row batch
            mixes decode rows (the degenerate chunk: one token at position
            ``ctx - 1``) and prefill rows (chunks of ≤ ``chunk_now`` prompt
            tokens) under a token budget.  ``step_mode="split"``: two calls
            per iteration, one batched prefill chunk
            (``transformer.sharded_prefill_chunk``) and one decode batch
            (``transformer.sharded_decode_step``).  Either way K/V is
            written in place into the pools and attended through block
            tables by hand-written CUDA kernels;
  balance — Θ-triggered re-dispatching and device-local LIFO handling of
            memory exhaustion (§5.3), with migration bytes scheduled by the
            Hauler into compute-overlap windows;
  clock   — a simulated clock advances by the profiler-modelled step time of
            the heterogeneous deployment (Table 1 device classes), while
            the token stream itself is exact compute.

The cluster's device classes are simulated: every pool shard lives on the
one torch ``device`` the engine runs on.  Shapes are pow2-bucketed as in
the reference, so each model call sees at most ``fused_bucket_count()``
(``bucket_count()`` and ``prefill_bucket_count()`` for the split calls)
distinct shapes.  Both paged schedules are ported; the dense oracle modes
and the per-module probe raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.cluster import ClusterSpec, Device
from repro_torch.core.costmodel import dense_flops_layer
from repro_torch.core.dispatcher import (AttnRequest, WorkerState,
                                         apply_placement,
                                         current_attention_time, dispatch_lp,
                                         grow_context,
                                         handle_memory_exhaustion,
                                         maybe_rebalance, release_request)
from repro_torch.core.hauler import MigrationScheduler, MigrationTask
from repro_torch.core.profiler import (analytic_attention_model,
                                       analytic_transfer_model)
from repro_torch.device import resolve
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache import PagedHeadCache
from repro_torch.serving.request import Request, RequestState
from repro_torch.telemetry import (MetricsRegistry, MetricsView, Tracer,
                                   count_recompiles)


def _bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (>= lo)."""
    b = max(1, lo)
    while b < n:
        b *= 2
    return b


def _pow2s(n: int) -> List[int]:
    """All bucket values up to _bucket(n): [1, 2, 4, ..., _bucket(n)]."""
    out, b = [], 1
    while b < n:
        out.append(b)
        b *= 2
    out.append(b)
    return out


def _bucket0(n: int) -> int:
    """_bucket with a 0 bucket: the staging-exchange lane axis is usually
    empty (single-device rows), and 0 lanes must not round up to 1."""
    return 0 if n == 0 else _bucket(n)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 32
    page_size: int = 16
    theta: float = 0.5              # re-dispatch trigger (paper Θ)
    cache_gb_per_device: Optional[Dict[int, float]] = None
    max_seq: int = 512
    # "paged": device-resident pools + hand-written kernels; only "paged"
    # is ported (the "dense" oracle modes are ROADMAP Queue A item 7)
    decode_mode: str = "paged"
    prefill_mode: str = "paged"
    prefill_chunk: int = 32         # max prompt tokens per chunk (pow2)
    # "fused": ONE model call per iteration packs decode rows and prefill
    # chunk tokens under the token budget; "split": one prefill-chunk call
    # and one decode call per iteration (the reference's fallback/oracle)
    step_mode: str = "fused"
    # per-step token budget for the fused packer; 0 = auto
    # (max_batch decode tokens + prefill_chunk prompt tokens)
    token_budget: int = 0
    # decode TPOT SLO (seconds of warm fused-step wall latency) driving
    # the per-step prefill chunk autotuner; 0 = autotuner off.  Timing the
    # step costs a device sync, so only enable when an SLO is configured.
    tpot_slo_s: float = 0.0
    # fraction of the modeled step time handed to the migration hauler as
    # compute-overlap window (§6)
    migration_overlap: float = 0.5
    # tracing: off by default (disabled tracer is zero-cost)
    telemetry: bool = False
    # the per-module probe is ROADMAP Queue A item 8
    trace_modules: bool = False
    trace_capacity: int = 65536     # tracer ring-buffer size (spans)


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params, cluster: ClusterSpec,
                 primary_ids: Sequence[int], pool_ids: Sequence[int],
                 engine_cfg: Optional[EngineConfig] = None,
                 device="cuda"):
        engine_cfg = EngineConfig() if engine_cfg is None \
            else engine_cfg
        self.device = resolve(device)
        self._check_supported(cfg, engine_cfg)
        self.cfg = cfg
        self.params = params
        self.cluster = cluster
        self.ecfg = engine_cfg
        self.profile = cfg.profile()

        # Dispatcher worker states from analytic profiler models
        devs = self._devs
        self.workers: List[WorkerState] = []
        pool_itemsize = PagedHeadCache.pool_dtype(cfg).itemsize
        slot_bytes = (2 * cfg.n_layers * engine_cfg.page_size * cfg.head_dim
                      * pool_itemsize)
        # physical pool only needs to back max_batch concurrent sequences
        # at max_seq, even if every head group lands on one device
        pages_per_seq = -(-engine_cfg.max_seq // engine_cfg.page_size)
        pool_cap = engine_cfg.max_batch * cfg.n_kv_heads * pages_per_seq
        self.device_slots: Dict[int, int] = {}
        for did in list(primary_ids) + list(pool_ids):
            d = devs[did]
            attn_model = analytic_attention_model(d.cls, self.profile)
            xfer = (None if did in primary_ids else
                    analytic_transfer_model(d.cls.inter_link_gbps))
            cap_gb = (engine_cfg.cache_gb_per_device or {}).get(
                did, d.cls.mem_gb * 0.3)
            cap_bytes = cap_gb * 1e9
            self.workers.append(WorkerState(did, attn_model, xfer,
                                            capacity_bytes=cap_bytes))
            by_mem = max(1, int(cap_bytes / max(1, slot_bytes)
                                / max(1, cfg.n_kv_heads)))
            self.device_slots[did] = min(by_mem, pool_cap)
        self.primary_ids = list(primary_ids)

        # Per-device pool shards, anchored on the first primary.  The
        # anchor's staging region must hold every remote page one step can
        # reference: <= max_batch rows x n_kv_heads chains x pages_per_seq
        # pages == pool_cap (single-partition engines need no staging).
        stage = pool_cap if len(self.device_slots) > 1 else 0
        self.kv = PagedHeadCache(cfg, self.device_slots,
                                 page_size=engine_cfg.page_size,
                                 anchor=self.primary_ids[0],
                                 stage_slots=stage, device=self.device)
        self._kv_itemsize = int(self.kv.dtype.itemsize)
        self.hauler = MigrationScheduler({})
        # Eq 6 reads REAL per-partition free bytes: clamp each worker's
        # accounting capacity to its pool shard's physical free space.
        for w in self.workers:
            part = self.kv.partitions[w.device_id]
            w.free_bytes_fn = (lambda p=part, kv=self.kv:
                               float(p.free * kv.bytes_per_slot()))

        self.queue: Deque[Request] = collections.deque()
        self.running: List[Request] = []
        # admitted but not fully written to the pool (chunked prefill)
        self.prefilling: List[Request] = []
        self.attn_reqs: Dict[int, AttnRequest] = {}
        self.finished: List[Request] = []
        self.clock = 0.0

        # ------------------------------------------------------- telemetry
        self.registry = MetricsRegistry()
        self.tracer = Tracer(enabled=engine_cfg.telemetry,
                             capacity=engine_cfg.trace_capacity)
        reg = self.registry
        self._c_migr = reg.counter("migrated_bytes")
        # device-to-device traffic of the sharded pools: re-dispatch
        # migrations (cross-pool page copies, budgeted by the hauler) and
        # the step's staging gathers/writebacks for multi-device rows
        self._c_d2d = reg.counter("migrate/d2d_bytes")
        self._c_migr_partial = reg.counter("migrate/partial")
        self._c_gather_d2d = reg.counter("fastpath/gather_d2d_bytes")
        self._c_evict = reg.counter("evictions")
        self._c_redisp = reg.counter("redispatches")
        self._c_steps = reg.counter("steps")
        self._c_h2d = reg.counter("h2d_bytes")
        self._c_d2h = reg.counter("d2h_bytes")
        self._c_pre_h2d = reg.counter("prefill_h2d_bytes")
        self._c_chunks = reg.counter("prefill_chunks")
        # distinct bucket shapes the model step has been called with
        self._c_recompiles = reg.counter("jit/recompiles")
        self._c_model_calls = reg.counter("model_calls")
        self._c_fused = reg.counter("fused_steps")
        self._c_slo_viol = reg.counter("tpot_slo_violations")
        self._c_undrained = reg.counter("run_undrained")
        self._h_fused_warm = reg.histogram("fused_warm_step_s")
        reg.gauge("prefill/chunk_now", fn=lambda: float(self._chunk_now))
        self._h_ttft = reg.histogram("ttft_s")
        self._h_tpot = reg.histogram("tpot_s")
        self._h_step = reg.histogram("step_latency_s")
        # KV-pool occupancy / per-device memory gauges: callable-backed —
        # evaluated at snapshot()/read time, zero cost per step
        for did, part in self.kv.partitions.items():
            reg.gauge(f"kv/device/{did}/used_slots",
                      fn=(lambda p=part: float(p.used)))
            reg.gauge(f"kv/device/{did}/used_bytes",
                      fn=(lambda p=part, kv=self.kv:
                          float(p.used * kv.bytes_per_slot())))
        reg.gauge("kv/occupancy", fn=self._pool_occupancy)
        # dense-module roofline efficiency of the modeled step time (the
        # reference's 0.5 analytic prior; its calibration from measured
        # module spans comes with the probe, ROADMAP Queue A item 8)
        self._dense_eff = 0.5
        # mapping view over the registry (the reference's metrics keys)
        self.metrics = MetricsView({
            "migrated_bytes": lambda: self._c_migr.value,
            "evictions": lambda: self._c_evict.value,
            "redispatches": lambda: self._c_redisp.value,
            "steps": lambda: self._c_steps.value,
            "h2d_bytes": lambda: self._c_h2d.value,
            "d2h_bytes": lambda: self._c_d2h.value,
            "prefill_h2d_bytes": lambda: self._c_pre_h2d.value,
            "prefill_chunks": lambda: self._c_chunks.value,
            "model_calls": lambda: self._c_model_calls.value,
            "fused_steps": lambda: self._c_fused.value,
            "ttft_p50": lambda: self._h_ttft.percentile(50),
            "ttft_p95": lambda: self._h_ttft.percentile(95),
        })

        # _check_supported admitted only configs with both paged paths
        self.use_paged = engine_cfg.decode_mode == "paged"
        self.use_paged_prefill = engine_cfg.prefill_mode == "paged"
        # anchor / anchor-sink are fixed per engine; the exchange lane
        # arrays stage remote pool shards' pages through the anchor inside
        # the same model call (see transformer.sharded_decode_step)
        anchor, asink = self.kv.anchor, self.kv.sink
        self._paged_fn = count_recompiles(
            lambda p, kp, vp, gd, gs, gt, wd, ws_, wt, bt, ln, ws, wo, t,
            pos: T.sharded_decode_step(
                cfg, p, kp, vp, anchor, asink, gd, gs, gt, wd, ws_, wt,
                bt, ln, ws, wo, t, pos), self._c_recompiles)
        self._chunk_fn = count_recompiles(
            lambda p, kp, vp, gd, gs, gt, wd, wsb, wt, bt, ln, st, ws, wo,
            t, li: T.sharded_prefill_chunk(
                cfg, p, kp, vp, anchor, asink, gd, gs, gt, wd, wsb, wt,
                bt, ln, st, ws, wo, t, li), self._c_recompiles)
        self._fused_fn = count_recompiles(
            lambda p, kp, vp, gd, gs, gt, wd, wsb, wt, bt, ln, st, ws, wo,
            t, li: T.sharded_fused_step(
                cfg, p, kp, vp, anchor, asink, gd, gs, gt, wd, wsb, wt,
                bt, ln, st, ws, wo, t, li), self._c_recompiles)
        self._decode_shapes: Set[Tuple[int, int, int]] = set()
        self._prefill_shapes: Set[Tuple[int, int, int, int]] = set()
        self.use_fused = engine_cfg.step_mode == "fused"
        # autotuned per-step prefill chunk, pow2 in [1, prefill_chunk]
        self._chunk_now = _bucket(engine_cfg.prefill_chunk)

    @staticmethod
    def _check_supported(cfg: ModelConfig, ecfg: EngineConfig) -> None:
        """Refuse configurations whose path is not ported rather than
        quietly running another one."""
        if ecfg.step_mode not in ("fused", "split"):
            raise ValueError(f"step_mode={ecfg.step_mode!r}: 'fused' or "
                             f"'split'")
        for name in ("decode_mode", "prefill_mode"):
            if getattr(ecfg, name) != "paged":
                raise NotImplementedError(
                    f"{name}={getattr(ecfg, name)!r}: the dense oracle "
                    f"modes are ROADMAP Queue A item 7")
        if ecfg.trace_modules:
            raise NotImplementedError(
                "trace_modules=True: the per-module probe is ROADMAP "
                "Queue A item 8 (telemetry on the port)")
        if not T.supports_fused_step(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the paged paths support pure-GQA, "
                f"full-attention, token-frontend configs; this one needs "
                f"the dense paths (ROADMAP Queue A items 7 and 10)")
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are ROADMAP Queue A item 2 "
                f"(moe_apply)")

    # --------------------------------------------------------------- cluster
    # ``cluster`` is a property so the device_id -> Device map the modeled-
    # time helpers consume is built once per cluster change.
    @property
    def cluster(self) -> ClusterSpec:
        return self._cluster

    @cluster.setter
    def cluster(self, cluster: ClusterSpec) -> None:
        self._cluster = cluster
        self._devs: Dict[int, Device] = {d.device_id: d
                                         for d in cluster.devices}

    # ------------------------------------------------------------- telemetry
    def _pool_occupancy(self) -> float:
        used = sum(p.used for p in self.kv.partitions.values())
        total = sum(p.total for p in self.kv.partitions.values())
        return used / total if total else 0.0

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
        """Typed metrics snapshot (see MetricsRegistry.snapshot)."""
        return self.registry.snapshot(prefix)

    def _upload(self, host: Tuple[np.ndarray, ...]
                ) -> Tuple[torch.Tensor, ...]:
        """Host arrays -> device tensors (same dtypes, same bytes)."""
        return tuple(torch.from_numpy(a).to(self.device) for a in host)

    # -------------------------------------------------------- shape bounds
    def _max_pages(self) -> int:
        return -(-self.ecfg.max_seq // self.ecfg.page_size)

    def _gw_pow2s(self) -> List[int]:
        """Bucket values of the staging-exchange lane axis: 0 (no remote
        pages this step) plus pow2s up to the staging capacity."""
        if self.kv.stage == 0:
            return [0]
        return [0] + _pow2s(self.kv.stage)

    def decode_bucket_shapes(self) -> List[Tuple[int, int, int]]:
        """Every (batch-bucket, pages-bucket, exchange-bucket) shape the
        paged decode step can be called at."""
        return [(b, p, g) for b in _pow2s(self.ecfg.max_batch)
                for p in _pow2s(self._max_pages())
                for g in self._gw_pow2s()]

    def prefill_bucket_shapes(self) -> List[Tuple[int, int, int, int]]:
        """Every (batch-bucket, chunk-bucket, pages-bucket,
        exchange-bucket) shape the prefill-chunk step can be called at;
        the fused step shares this universe."""
        return [(b, c, p, g) for b in _pow2s(self.ecfg.max_batch)
                for c in _pow2s(self.ecfg.prefill_chunk)
                for p in _pow2s(self._max_pages())
                for g in self._gw_pow2s()]

    def fused_bucket_shapes(self) -> List[Tuple[int, int, int, int]]:
        """Every (batch-bucket, chunk-bucket, pages-bucket,
        exchange-bucket) shape the fused step can be called at."""
        return self.prefill_bucket_shapes()

    def bucket_count(self) -> int:
        """Upper bound on the distinct shapes of the paged decode step."""
        return len(self.decode_bucket_shapes())

    def prefill_bucket_count(self) -> int:
        """Upper bound on the distinct shapes of the prefill-chunk step."""
        return len(self.prefill_bucket_shapes())

    def fused_bucket_count(self) -> int:
        """Upper bound on the distinct shapes of the fused step."""
        return len(self.fused_bucket_shapes())

    def decode_compile_count(self) -> int:
        """Distinct shapes the paged decode step has been called with."""
        return self._paged_fn._cache_size()

    def prefill_compile_count(self) -> int:
        """Distinct shapes the prefill-chunk step has been called with."""
        return self._chunk_fn._cache_size()

    def fused_compile_count(self) -> int:
        """Distinct shapes the fused step has been called with so far."""
        return self._fused_fn._cache_size()

    # ------------------------------------------------------------------ admit
    def submit(self, req: Request) -> None:
        req.arrival = req.arrival or self.clock
        self.queue.append(req)

    def _try_admit(self) -> List[Request]:
        admitted = []
        while self.queue and (len(self.running) + len(self.prefilling)
                              < self.ecfg.max_batch):
            req = self.queue[0]
            if req.arrival > self.clock:
                if not self.running and not self.prefilling and not admitted:
                    # idle: jump to the next arrival
                    self.clock = req.arrival
                else:
                    break
            ar = AttnRequest(rid=req.rid, ctx_len=req.ctx_len,
                             n_heads=self.cfg.n_heads,
                             group_ratio=self.cfg.gqa_ratio,
                             head_dim=self.cfg.head_dim,
                             dtype_bytes=self._kv_itemsize,
                             arrival=req.arrival)
            placement = dispatch_lp(self.workers, [ar])
            if placement is None:
                break
            apply_placement(self.workers, [ar], placement)
            req.placement = placement[ar.rid]
            self.attn_reqs[req.rid] = ar
            # page allocation per kv group on assigned devices
            ok = self._alloc_pages(req, ar)
            if not ok:
                release_request(self.workers, ar)
                del self.attn_reqs[req.rid]
                break
            self.queue.popleft()
            admitted.append(req)
        return admitted

    def _groups_by_device(self, placement: Dict[int, int]) -> Dict[int, int]:
        """query-head placement -> kv-group counts per device."""
        r = self.cfg.gqa_ratio
        return {dev: heads // r for dev, heads in placement.items()}

    def _alloc_pages(self, req: Request, ar: AttnRequest) -> bool:
        g = 0
        for dev, ngroups in self._groups_by_device(req.placement).items():
            for _ in range(ngroups):
                if not self.kv.ensure_capacity(req.rid, g, dev,
                                               req.ctx_len):
                    self.kv.release(req.rid)
                    return False
                self.kv.lengths[(req.rid, g)] = req.ctx_len
                g += 1
        return g == self.cfg.n_kv_heads

    # ----------------------------------------------------------------- decode
    def _reserve_decode_rows(self, reqs: List[Request]) -> List[Request]:
        """Reserve page room for this step's token in every group chain;
        exhaustion triggers §5.3 handling, which may preempt requests
        (possibly the one being reserved, possibly a prefilling one) out
        of this step's batch.  Returns the rows that survived with
        capacity in hand."""
        active: List[Request] = []
        for r in reqs:
            if r not in self.running:
                continue                       # evicted by a prior handler
            ok = True
            for grp, dev in self._group_devices(r):
                n = r.ctx_len - 1              # tokens stored so far
                if self.kv.ensure_capacity(r.rid, grp, dev, n + 1):
                    continue
                self._on_memory_exhausted(dev)
                if r not in self.running or \
                        not self.kv.ensure_capacity(r.rid, grp, dev, n + 1):
                    ok = False
                    break
            if ok and r in self.running:
                active.append(r)
        return [r for r in active if r in self.running]

    # ----------------------------------------------------------- split steps
    def _prefill_chunk_step(self) -> None:
        """Run ONE prompt chunk of ≤ ``prefill_chunk`` tokens for every
        prefilling request, batched into a single model call.  K/V lands
        directly in the pools; a request whose chunk completes its prompt
        (incl. preemption-replay tokens) samples its first token and joins
        this step's decode batch."""
        rows = [(r, r.prompt + r.output) for r in self.prefilling]
        if not rows:
            return
        cfg = self.cfg
        Hkv, page = cfg.n_kv_heads, self.kv.page
        chunk = self.ecfg.prefill_chunk
        spans = [(r, full, min(chunk, len(full) - r.prefill_pos))
                 for r, full in rows]
        Bp = _bucket(len(spans))
        Cp = _bucket(max(n for _, _, n in spans))
        maxp = max(-(-(r.prefill_pos + n) // page) for r, _, n in spans)
        Pp = _bucket(maxp)
        sink = self.kv.sink
        plan = self.kv.step_plan()
        toks = np.zeros((Bp, Cp), np.int32)
        starts = np.zeros((Bp,), np.int32)
        lengths = np.zeros((Bp,), np.int32)
        last_idx = np.zeros((Bp,), np.int32)
        tables = np.full((Bp, Hkv, Pp), sink, np.int32)
        wslots = np.full((Bp, Hkv, Cp), sink, np.int32)
        woffs = np.zeros((Bp, Cp), np.int32)
        for i, (r, full, n) in enumerate(spans):
            s0 = r.prefill_pos
            toks[i, :n] = full[s0:s0 + n]
            starts[i] = s0
            lengths[i] = s0 + n
            last_idx[i] = n - 1
            slots, offs = plan.scatter_indices(r.rid, s0, n)
            wslots[i, :, :n] = slots
            woffs[i, :n] = offs
            # the kernel only reads keys below lengths[i], so only those
            # pages are staged from remote shards
            tables[i] = plan.block_table_matrix(r.rid, Pp,
                                                n_tokens=s0 + n)
        Gp = _bucket0(plan.gather_count)
        exch = plan.exchange_arrays(Gp)
        self._prefill_shapes.add((Bp, Cp, Pp, Gp))
        host = exch + (tables, lengths, starts, wslots, woffs, toks,
                       last_idx)
        h2d = sum(a.nbytes for a in host)
        dev = self._upload(host)
        self._c_gather_d2d.inc(plan.d2d_bytes())
        with self.tracer.span("prefill_chunk",
                              args={"batch": Bp, "chunk": Cp, "pages": Pp}):
            kps, vps = self.kv.pools()
            logits, kps, vps = self._chunk_fn(self.params, kps, vps, *dev)
            self.kv.install_pools(kps, vps)
            self.tracer.sync(logits)
        self._c_model_calls.inc()
        self._c_h2d.inc(h2d)
        self._c_pre_h2d.inc(h2d)
        self._c_chunks.inc()
        self.clock += self._model_prefill_time(
            sum(n for _, _, n in spans))
        nxt = None
        for i, (r, full, n) in enumerate(spans):
            r.prefill_pos += n
            if r.prefill_pos < len(full):
                continue
            if nxt is None:             # logits pulled once, on demand
                nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
                self._c_d2h.inc(logits.numel() * logits.element_size())
            r.output.append(int(nxt[i]))
            r.state = RequestState.RUNNING
            self.prefilling.remove(r)
            self.running.append(r)
            if r.ttft is None:
                r.ttft = self.clock - r.arrival
                self._h_ttft.observe(r.ttft)
            if r.done:      # max_new_tokens == 1, or resume filled the last
                self._finish(r)

    def _decode_batch(self) -> None:
        """ONE paged decode call for every running request: block tables
        over the pools, the new token's K/V written in place."""
        reqs = [r for r in self.running if not r.done]
        if not reqs:
            return
        cfg = self.cfg
        Hkv, page = cfg.n_kv_heads, self.kv.page
        active = self._reserve_decode_rows(reqs)
        if not active:
            return
        B = len(active)
        Bp = _bucket(B)
        maxp = max(-(-r.ctx_len // page) for r in active)
        Pp = _bucket(maxp)
        sink = self.kv.sink
        plan = self.kv.step_plan()
        tables = np.full((Bp, Hkv, Pp), sink, np.int32)
        lengths = np.zeros((Bp,), np.int32)
        wslot = np.full((Bp, Hkv), sink, np.int32)
        woff = np.zeros((Bp,), np.int32)
        pos = np.zeros((Bp,), np.int32)
        toks = np.zeros((Bp, 1), np.int32)
        for i, r in enumerate(active):
            p_new = r.ctx_len - 1
            tables[i] = plan.block_table_matrix(r.rid, Pp,
                                                n_tokens=p_new + 1)
            slots, offs = plan.scatter_indices(r.rid, p_new, 1)
            wslot[i] = slots[:, 0]
            lengths[i] = p_new + 1
            woff[i] = offs[0]
            pos[i] = p_new
            toks[i, 0] = r.output[-1]
        Gp = _bucket0(plan.gather_count)
        exch = plan.exchange_arrays(Gp)
        self._decode_shapes.add((Bp, Pp, Gp))
        host = exch + (tables, lengths, wslot, woff, toks, pos)
        h2d = sum(a.nbytes for a in host)
        dev = self._upload(host)
        self._c_gather_d2d.inc(plan.d2d_bytes())
        with self.tracer.span("paged_decode",
                              args={"batch": Bp, "pages": Pp}):
            kps, vps = self.kv.pools()
            logits, kps, vps = self._paged_fn(self.params, kps, vps, *dev)
            self.kv.install_pools(kps, vps)
            self.tracer.sync(logits)
        self._c_model_calls.inc()
        self._c_h2d.inc(h2d)
        nxt = logits[:B].argmax(dim=-1).to(torch.int32).cpu().numpy()
        # the whole padded logits array is metered, as the reference does
        self._c_d2h.inc(logits.numel() * logits.element_size())
        for r in active:
            # the reservation already advanced kv.lengths; the step
            # scattered the token K/V into those pages on device
            grow_context(self.workers, self.attn_reqs[r.rid], 1)
        for i, r in enumerate(active):
            r.output.append(int(nxt[i]))
            if r.done:
                self._finish(r)

    # ------------------------------------------------------------ fused step
    def _fused_step(self) -> None:
        """ONE model call per iteration: the row batch mixes decode rows
        (one token at position ``ctx - 1``) and prefill rows (FCFS chunks
        of ≤ ``chunk_now`` prompt tokens), packed under the per-step token
        budget.  Decode rows are always admitted; prefill tokens fill the
        remainder."""
        cfg = self.cfg
        Hkv, page = cfg.n_kv_heads, self.kv.page
        # reserve decode capacity FIRST: §5.3 handling inside may preempt
        # prefilling requests, which must not be in this step's row batch
        dec = self._reserve_decode_rows(
            [r for r in self.running if not r.done])
        budget = self.ecfg.token_budget or (self.ecfg.max_batch
                                            + self.ecfg.prefill_chunk)
        left = budget - len(dec)        # decode rows always admitted
        spans: List[Tuple[Request, List[int], int]] = []
        for r in self.prefilling:
            if left <= 0:
                break
            full = r.prompt + r.output
            n = min(self._chunk_now, len(full) - r.prefill_pos, left)
            if n <= 0:
                break
            spans.append((r, full, n))
            left -= n
        if not dec and not spans:
            return
        rows = ([(r.rid, r.ctx_len - 1, 1) for r in dec]
                + [(r.rid, r.prefill_pos, n) for r, _, n in spans])
        B = len(rows)
        Bp = _bucket(B)
        Cp = _bucket(max(n for _, _, n in rows))
        maxp = max(-(-(s + n) // page) for _, s, n in rows)
        Pp = _bucket(maxp)
        sink = self.kv.sink
        plan = self.kv.step_plan()
        toks = np.zeros((Bp, Cp), np.int32)
        starts = np.zeros((Bp,), np.int32)
        lengths = np.zeros((Bp,), np.int32)
        last_idx = np.zeros((Bp,), np.int32)
        tables = np.full((Bp, Hkv, Pp), sink, np.int32)
        ws, wo = plan.mixed_scatter_indices(rows, Cp)
        wslots = np.full((Bp, Hkv, Cp), sink, np.int32)
        woffs = np.zeros((Bp, Cp), np.int32)
        wslots[:B] = ws
        woffs[:B] = wo
        for i, (rid, s0, n) in enumerate(rows):
            starts[i] = s0
            lengths[i] = s0 + n
            last_idx[i] = n - 1
            # the chain covers the FULL prompt; the kernel only reads
            # keys below lengths[i], so only those pages are staged from
            # remote shards (anchor-local pages keep the full chain)
            tables[i] = plan.block_table_matrix(rid, Pp, n_tokens=s0 + n)
        for i, r in enumerate(dec):
            toks[i, 0] = r.output[-1]
        for j, (r, full, n) in enumerate(spans):
            toks[len(dec) + j, :n] = full[r.prefill_pos:r.prefill_pos + n]
        Gp = _bucket0(plan.gather_count)
        exch = plan.exchange_arrays(Gp)
        host = exch + (tables, lengths, starts, wslots, woffs, toks,
                       last_idx)
        h2d = sum(a.nbytes for a in host)
        dev = self._upload(host)
        self._c_gather_d2d.inc(plan.d2d_bytes())
        tr = self.tracer
        n_pre = sum(n for _, _, n in spans)
        # timing the step for the autotuner costs a device sync, so only
        # pay it when an SLO is configured
        time_it = self.ecfg.tpot_slo_s > 0.0
        rc0 = self._c_recompiles.value
        with tr.span("fused_step", args={"batch": Bp, "chunk": Cp,
                                         "pages": Pp,
                                         "decode_rows": len(dec),
                                         "prefill_tokens": n_pre}):
            t0 = time.perf_counter() if (tr.enabled or time_it) else 0.0
            kps, vps = self.kv.pools()
            logits, kps, vps = self._fused_fn(self.params, kps, vps, *dev)
            self.kv.install_pools(kps, vps)
            tr.sync(logits)
            if tr.enabled or time_it:
                if not tr.enabled and logits.is_cuda:
                    torch.cuda.synchronize(logits.device)
                dt = time.perf_counter() - t0
                if tr.enabled:
                    # attribute the ONE measured call to its phases by
                    # token share — both phases ran inside one call
                    tr.add_phase_spans(
                        "fused/", t0, dt,
                        {"decode": float(len(dec)),
                         "prefill": float(n_pre)},
                        depth=len(tr._stack))
                if time_it and self._c_recompiles.value == rc0:
                    self._autotune_chunk(dt)
        self._c_model_calls.inc()
        self._c_fused.inc()
        self._c_h2d.inc(h2d)
        if spans:
            self._c_pre_h2d.inc(h2d)
            self._c_chunks.inc()
            self.clock += self._model_prefill_time(n_pre)
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self._c_d2h.inc(logits.numel() * logits.element_size())
        for r in dec:
            # the reservation already advanced kv.lengths; the step
            # scattered the token K/V into those pages on device
            grow_context(self.workers, self.attn_reqs[r.rid], 1)
        for i, r in enumerate(dec):
            r.output.append(int(nxt[i]))
            if r.done:
                self._finish(r)
        for j, (r, full, n) in enumerate(spans):
            r.prefill_pos += n
            if r.prefill_pos < len(full):
                continue
            r.output.append(int(nxt[len(dec) + j]))
            r.state = RequestState.RUNNING
            self.prefilling.remove(r)
            self.running.append(r)
            if r.ttft is None:
                r.ttft = self.clock - r.arrival
                self._h_ttft.observe(r.ttft)
            if r.done:      # max_new_tokens == 1, or resume filled the last
                self._finish(r)

    def _autotune_chunk(self, warm_s: float) -> None:
        """Feed one warm fused-step wall latency (a step whose shape was
        seen before) to the chunk autotuner: when the EWMA overruns the
        decode TPOT SLO the prefill chunk halves; with ≥2x headroom it
        doubles back.  Pow2 moves clamped to [1, prefill_chunk] keep every
        reachable shape inside ``fused_bucket_shapes()``."""
        self._h_fused_warm.observe(warm_s)
        slo = self.ecfg.tpot_slo_s
        if warm_s > slo:
            self._c_slo_viol.inc()
        ew = self._h_fused_warm.ewma
        if ew > slo and self._chunk_now > 1:
            self._chunk_now //= 2
        elif (ew < 0.5 * slo
              and self._chunk_now < _bucket(self.ecfg.prefill_chunk)):
            self._chunk_now *= 2

    def _group_devices(self, req: Request):
        out = []
        g = 0
        for dev, ngroups in self._groups_by_device(req.placement).items():
            for _ in range(ngroups):
                out.append((g, dev))
                g += 1
        return out

    def _finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = self.clock
        if req.ttft is not None and len(req.output) > 1:
            decode_s = max(0.0, (self.clock - req.arrival) - req.ttft)
            self._h_tpot.observe(decode_s / (len(req.output) - 1))
        self.kv.release(req.rid)
        ar = self.attn_reqs.pop(req.rid, None)
        if ar is not None:
            release_request(self.workers, ar)
        self.running.remove(req)
        self.finished.append(req)

    # ---------------------------------------------------------------- balance
    def _on_memory_exhausted(self, device_id: int) -> None:
        decisions, evicted = handle_memory_exhaustion(
            self.workers, list(self.attn_reqs.values()), device_id,
            theta=self.ecfg.theta)
        for d in decisions:
            self._apply_migration(d.request.rid, d.new_placement)
            self._c_redisp.inc()
        for ar in evicted:
            req = next(r for r in self.running + self.prefilling
                       if r.rid == ar.rid)
            self._preempt(req)

    def _preempt(self, req: Request) -> None:
        """Device-local LIFO eviction (§5.3): release the request's pages
        and requeue it at the front; it resumes by replaying prompt +
        generated tokens chunk by chunk."""
        self.kv.release(req.rid)
        req.state = RequestState.PREEMPTED
        req.placement = {}
        req.prefill_pos = 0
        if req in self.running:
            self.running.remove(req)
        if req in self.prefilling:
            self.prefilling.remove(req)
        self.attn_reqs.pop(req.rid, None)
        self.queue.appendleft(req)
        self._c_evict.inc()

    def _apply_migration(self, rid: int, new_placement: Dict[int, int]
                         ) -> None:
        req = next((r for r in self.running + self.prefilling
                    if r.rid == rid), None)
        if req is None:
            return
        req.placement = dict(new_placement)
        # Move group chains to their new devices by cross-pool copy.  Only
        # bytes that PHYSICALLY moved are metered and handed to the hauler
        # (as per-source-device tasks debited against the compute-overlap
        # window in step()); an all-or-nothing refusal (destination shard
        # full) is surfaced instead of silently booked.
        moved_bytes = 0.0
        tasks: List[MigrationTask] = []
        incomplete = 0
        for grp, dev in self._group_devices(req):
            res = self.kv.migrate_group(rid, grp, dev)
            if not res.complete:
                incomplete += 1
                continue
            moved_bytes += res.nbytes
            for src, pages in res.by_src.items():
                tasks.append(MigrationTask(
                    rid, src, dev, heads=float(self.cfg.gqa_ratio),
                    nbytes=float(pages * self.kv.bytes_per_slot())))
        if incomplete:
            self._c_migr_partial.inc(incomplete)
            warnings.warn(
                f"migration of rid={rid} incomplete: {incomplete} head "
                f"group(s) stayed on their source device (destination "
                f"pool shard full); physical placement diverges from the "
                f"dispatcher's until pages free up", RuntimeWarning,
                stacklevel=2)
        if tasks:
            self.hauler.submit(tasks)
        self._c_migr.inc(moved_bytes)
        self._c_d2d.inc(moved_bytes)

    # ------------------------------------------------------------------- step
    def step(self) -> Dict[str, float]:
        tr = self.tracer
        t_wall = time.perf_counter() if tr.enabled else 0.0
        with tr.span("step"):
            with tr.span("admit"):
                admitted = self._try_admit()
            for req in admitted:
                req.prefill_start = self.clock
                # chunked: prompt writes spread over the next steps,
                # interleaved with decode — no head-of-line blocking
                self.prefilling.append(req)
            if self.use_fused:
                # ONE model call packs decode rows + prefill chunks
                self._fused_step()
            else:
                # a prefill-chunk call, then a decode call in which the
                # requests that just finished their prompts already decode
                self._prefill_chunk_step()
                self._decode_batch()
            # Θ-triggered rebalance (at most one request per step, §5.3)
            d = maybe_rebalance(self.workers, list(self.attn_reqs.values()),
                                theta=self.ecfg.theta)
            if d is not None:
                with tr.span("rebalance", args={"rid": d.request.rid}):
                    self._apply_migration(d.request.rid, d.new_placement)
                self._c_redisp.inc()
            attn_t, dense_t = self._model_decode_parts()
            step_time = attn_t + dense_t
            if tr.enabled:
                # modeled module spans on the simulated-clock track
                tr.add_span("attention_model", self.clock, attn_t,
                            track="sim")
                tr.add_span("dense_model", self.clock + attn_t, dense_t,
                            track="sim")
            # migrations ride in the dense-compute overlap window (§6)
            self.hauler.advance(step_time * self.ecfg.migration_overlap)
            self.clock += step_time
            self._c_steps.inc()
        if tr.enabled:
            self._h_step.observe(time.perf_counter() - t_wall)
        return {"clock": self.clock, "running": len(self.running),
                "prefilling": len(self.prefilling),
                "queued": len(self.queue)}

    # ------------------------------------------------------ simulated timing
    def _model_prefill_time(self, prompt_len: int) -> float:
        devs = self._devs
        t = 0.0
        for did in self.primary_ids:
            cls = devs[did].cls
            fl = dense_flops_layer(self.profile, prompt_len) \
                * self.profile.n_layers / len(self.primary_ids)
            t = max(t, fl / (cls.dense_tflops * 1e12 * self._dense_eff))
        return t

    def _model_decode_parts(self) -> Tuple[float, float]:
        """(attention, dense) modeled step seconds."""
        if not self.attn_reqs:
            return 1e-4, 0.0
        r0 = next(iter(self.attn_reqs.values()))
        attn_t = current_attention_time(self.workers, r0.group_ratio,
                                        r0.head_dim, r0.dtype_bytes)
        devs = self._devs
        dense_t = 0.0
        nb = max(1, len(self.running))
        for did in self.primary_ids:
            cls = devs[did].cls
            fl = dense_flops_layer(self.profile, nb) * self.profile.n_layers \
                / len(self.primary_ids)
            dense_t = max(dense_t, fl / (cls.dense_tflops * 1e12
                                         * self._dense_eff))
        return attn_t, dense_t

    # ------------------------------------------------------------------- run
    def run_until_drained(self, max_steps: int = 10000) -> bool:
        """Step until every request finishes or ``max_steps`` elapse.
        Returns ``True`` when drained; hitting the step cap with work
        still queued/running warns and bumps the ``run_undrained``
        counter instead of exiting silently."""
        for _ in range(max_steps):
            if not self.queue and not self.running and not self.prefilling:
                return True
            self.step()
        if self.queue or self.running or self.prefilling:
            self._c_undrained.inc()
            warnings.warn(
                f"run_until_drained exiting at max_steps={max_steps} with "
                f"{len(self.queue)} queued / {len(self.running)} running / "
                f"{len(self.prefilling)} prefilling requests unfinished",
                RuntimeWarning, stacklevel=2)
            return False
        return True
