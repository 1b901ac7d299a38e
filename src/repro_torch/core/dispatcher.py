"""Online head-wise dispatching (paper §5.2) and re-dispatching (§5.3).

Formulation (Eq 7): choose x_i^j — query heads of request j placed on worker
i — to minimize the max per-worker Attention time

    min max_i f_i(x_i)
    s.t.  g_i + sum_j kvb_j * l_j * x_i^j <= M_i          (capacity, Eq 6)
          sum_i x_i^j = H_j                               (head integrity, Eq 5)
          x_i^j / r_j integral                            (group granularity)

with, for primary workers (no network),
    f_i = a_i (h_i + sum_j x_i^j) + b_i (g_i + sum_j kvb_j l_j x_i^j) + c_i
and for attention workers (paper's network-attached pool),
    f_i = (a_i + (2 + 2/r) * hb * gamma_i)(h_i + sum x) + b_i (...) + c_i + beta_i

where kvb_j = 2*head_dim*dtype/r per token per query head and hb =
head_dim*dtype (per-head activation bytes).  We keep g in *bytes* so GQA and
MHA are handled uniformly (the paper's r M_i/2 capacity form is equivalent).

The LP relaxation is solved with scipy's HiGHS and rounded to head-group
integrality by largest remainder under capacity feasibility.  A greedy
water-filling solver is provided both as a fallback and as a speed baseline.

Two shapes the engine asks for on every step skip HiGHS where its answer
is known without it, so every decision stays the one the LP makes:

* the re-dispatch check (``maybe_rebalance``) compares the current time
  with a lower bound on f* (:func:`_ideal_lower_bound`, the
  capacity-free LP's dual) and solves f*'s LP only when the bound does
  not settle "no";
* one request's placement (``dispatch_lp`` of one request) is the water
  level of its heads over the workers' loads (:func:`_water_fill`) where
  that is the LP's unique optimum, no capacity row binds and the rounding
  cannot tip; else HiGHS solves it.

``SOLVES`` counts HiGHS's solves and the ones each shortcut made.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiler import AttentionModel, TransferModel

try:  # scipy is available offline in this container
    from scipy.optimize import linprog
    HAVE_SCIPY = True
except Exception:  # pragma: no cover
    HAVE_SCIPY = False

# HiGHS's solves (``lp``), re-dispatch checks settled by the bound on f*
# (``bound``) and single-request placements by water level (``water``)
SOLVES: Dict[str, int] = {"lp": 0, "bound": 0, "water": 0}
# relative distance from a decision's edge below which the shortcuts leave
# the decision to HiGHS (its solutions of the cases they take agree with
# the closed forms to about 1e-13)
_EDGE = 1e-6


@dataclasses.dataclass
class WorkerState:
    """Dispatcher's view of one device participating in decode Attention."""

    device_id: int
    attn: AttentionModel
    xfer: Optional[TransferModel]       # None => primary worker (local)
    capacity_bytes: float               # M_i: bytes of KV cache it may host
    heads: float = 0.0                  # h_i(t)
    cache_bytes: float = 0.0            # g_i(t)
    alive: bool = True
    # measured/analytic attention-time ratio from the telemetry snapshot
    # (calibrate_from_snapshot); scales every f_i term so dispatch and
    # re-dispatch decisions follow *measured* latency, not just the static
    # profile.  1.0 = trust the analytic model.
    calib: float = 1.0
    # physical free-bytes probe of this device's KV pool shard (the engine
    # wires it to its PagedHeadCache partition); when set, Eq 6 capacity
    # decisions clamp the byte accounting to REAL per-partition free space
    # — page-granular allocation can exhaust a pool before the token-level
    # bookkeeping does.  None = accounting only (standalone dispatcher).
    free_bytes_fn: Optional[Callable[[], float]] = None

    def eff_a(self, group_ratio: int, head_dim: int, dtype_bytes: int) -> float:
        """Per-head slope including the per-head transfer volume (Eq 4)."""
        if self.xfer is None:
            return self.calib * self.attn.a
        per_head_bytes = (2.0 + 2.0 / group_ratio) * head_dim * dtype_bytes
        return self.calib * (self.attn.a + per_head_bytes * self.xfer.gamma)

    def eff_b(self) -> float:
        """Per-cache-byte slope under the measured calibration factor."""
        return self.calib * self.attn.b

    def const(self) -> float:
        c = self.attn.c
        if self.xfer is not None:
            c += self.xfer.beta
        return self.calib * c

    def f_time(self, group_ratio: int, head_dim: int, dtype_bytes: int,
               extra_heads: float = 0.0, extra_bytes: float = 0.0) -> float:
        """f_i with optional hypothetical additional load."""
        a = self.eff_a(group_ratio, head_dim, dtype_bytes)
        return (a * (self.heads + extra_heads)
                + self.eff_b() * (self.cache_bytes + extra_bytes)
                + self.const())

    def free_bytes(self) -> float:
        acct = max(0.0, self.capacity_bytes - self.cache_bytes)
        if self.free_bytes_fn is None:
            return acct
        return min(acct, max(0.0, float(self.free_bytes_fn())))


@dataclasses.dataclass
class AttnRequest:
    """One inference request's Attention footprint."""

    rid: int
    ctx_len: int                 # l_j(t), tokens currently in context
    n_heads: int                 # H, query heads
    group_ratio: int             # r = Hq / Hkv
    head_dim: int
    dtype_bytes: int = 2
    arrival: float = 0.0
    placement: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def n_groups(self) -> int:
        return self.n_heads // self.group_ratio

    def kv_bytes_per_token_per_head(self) -> float:
        """KV bytes per context token per *query* head (K and V, shared r-way)."""
        return 2.0 * self.head_dim * self.dtype_bytes / self.group_ratio

    def kv_bytes_per_head(self) -> float:
        return self.ctx_len * self.kv_bytes_per_token_per_head()

    def total_kv_bytes(self) -> float:
        return self.n_heads * self.kv_bytes_per_head()


Placement = Dict[int, Dict[int, int]]   # rid -> {device_id -> query heads}


# ---------------------------------------------------------------------------
# LP solve + rounding
# ---------------------------------------------------------------------------

def _live(workers: Sequence[WorkerState]) -> List[WorkerState]:
    return [w for w in workers if w.alive]


def dispatch_lp(workers: Sequence[WorkerState], requests: Sequence[AttnRequest]
                ) -> Optional[Placement]:
    """Solve Eq (7) for the batch of new requests; returns rounded placement
    or None when the cluster cannot host the requests at all."""
    ws = _live(workers)
    if not ws or not requests:
        return {} if not requests else None
    N, J = len(ws), len(requests)

    # feasibility pre-check (total capacity)
    need = sum(r.total_kv_bytes() for r in requests)
    if need > sum(w.free_bytes() for w in ws) + 1e-6:
        return None

    x = None
    if HAVE_SCIPY:
        if J == 1:
            x = _water_fill(ws, requests[0])
        if x is None:
            x = _solve_relaxation(ws, requests)
    if x is None:
        x = _greedy_relaxation(ws, requests)
    return _round_to_groups(ws, requests, x)


def _water_fill(ws: List[WorkerState], r: AttnRequest
                ) -> Optional[np.ndarray]:
    """The LP's x, as (N, 1), for the one request ``r`` where it is known
    without HiGHS; else None.

    Worker i's time rises from its load f_i by alpha_i a head, so the
    capacity-free optimum fills the workers to the level T at which
    sum_i max(0, (T - f_i) / alpha_i) = H.  Its x is the LP's unique
    optimum when T lies above every load (each worker takes heads), or
    when one worker lies below the busiest and T below that (all H heads
    to it; the others' times cannot rise) -- and when no worker's bytes
    reach its free bytes.  Near an edge of these, or where the rounding
    to head groups would tip on a last digit (an x / r near an integer,
    two remainders near each other), HiGHS decides."""
    g, dh, db = r.group_ratio, r.head_dim, r.dtype_bytes
    s = r.ctx_len * r.kv_bytes_per_token_per_head()
    slope = np.array([w.eff_a(g, dh, db) + w.eff_b() * s for w in ws])
    load = np.array([w.f_time(g, dh, db) for w in ws])
    if not (slope > 0.0).all():
        return None
    order = np.argsort(load, kind="stable")
    f, inv = load[order], 1.0 / slope[order]
    levels = (r.n_heads + np.cumsum(f * inv)) / np.cumsum(inv)
    k = int(np.argmax(np.append(levels[:-1] <= f[1:], True)))
    level, top = levels[k], f[-1]
    x = np.zeros(len(ws))
    if level - top > _EDGE * abs(top) and len(ws) > 1:
        x = (level - load) / slope
        frac = x / g
        rem = np.sort(frac - np.floor(frac))
        if (np.abs(frac - np.rint(frac)).min() < _EDGE
                or np.diff(rem).min() < _EDGE):
            return None
    elif (len(ws) == 1 or (top - level > _EDGE * abs(top)
                           and int((load < top).sum()) == 1)):
        x[order[0]] = r.n_heads
    else:
        return None
    free = np.array([w.free_bytes() for w in ws])
    if (x * s > free * (1.0 - _EDGE)).any():
        return None
    SOLVES["water"] += 1
    return x[:, None]


def _solve_relaxation(ws: List[WorkerState], requests: Sequence[AttnRequest]
                      ) -> Optional[np.ndarray]:
    """LP over variables [x_00..x_(N-1)(J-1), T]; returns x as (N, J)."""
    SOLVES["lp"] += 1
    N, J = len(ws), len(requests)
    nvar = N * J + 1
    c = np.zeros(nvar)
    c[-1] = 1.0  # minimize T

    A_ub, b_ub = [], []
    # f_i(x) - T <= -(base_i)
    for i, w in enumerate(ws):
        row = np.zeros(nvar)
        for j, r in enumerate(requests):
            a = w.eff_a(r.group_ratio, r.head_dim, r.dtype_bytes)
            row[i * J + j] = a + w.eff_b() * r.ctx_len * r.kv_bytes_per_token_per_head()
        row[-1] = -1.0
        base = w.f_time(requests[0].group_ratio, requests[0].head_dim,
                        requests[0].dtype_bytes)
        A_ub.append(row)
        b_ub.append(-base)
        # capacity
        cap = np.zeros(nvar)
        for j, r in enumerate(requests):
            cap[i * J + j] = r.ctx_len * r.kv_bytes_per_token_per_head()
        A_ub.append(cap)
        b_ub.append(w.free_bytes())

    A_eq, b_eq = [], []
    for j, r in enumerate(requests):
        row = np.zeros(nvar)
        for i in range(N):
            row[i * J + j] = 1.0
        A_eq.append(row)
        b_eq.append(float(r.n_heads))

    bounds = [(0.0, None)] * (N * J) + [(None, None)]
    res = linprog(c, A_ub=np.array(A_ub), b_ub=np.array(b_ub),
                  A_eq=np.array(A_eq), b_eq=np.array(b_eq), bounds=bounds,
                  method="highs")
    if not res.success:
        return None
    return res.x[:-1].reshape(N, J)


def _greedy_relaxation(ws: List[WorkerState], requests: Sequence[AttnRequest]
                       ) -> np.ndarray:
    """Water-filling: place one head group at a time on the worker whose
    incremental f_i is smallest (respecting capacity)."""
    N, J = len(ws), len(requests)
    x = np.zeros((N, J))
    h_extra = np.zeros(N)
    g_extra = np.zeros(N)
    for j, r in enumerate(requests):
        gb = r.group_ratio * r.kv_bytes_per_head()  # bytes per group
        for _ in range(r.n_groups):
            best_i, best_t = -1, float("inf")
            for i, w in enumerate(ws):
                if w.free_bytes() - g_extra[i] < gb - 1e-9:
                    continue
                t = w.f_time(r.group_ratio, r.head_dim, r.dtype_bytes,
                             h_extra[i] + r.group_ratio,
                             g_extra[i] + gb)
                if t < best_t:
                    best_t, best_i = t, i
            if best_i < 0:
                best_i = int(np.argmax([w.free_bytes() - g for w, g in
                                        zip(ws, g_extra)]))
            x[best_i, j] += r.group_ratio
            h_extra[best_i] += r.group_ratio
            g_extra[best_i] += gb
    return x


def _round_to_groups(ws: List[WorkerState], requests: Sequence[AttnRequest],
                     x: np.ndarray) -> Optional[Placement]:
    """Largest-remainder rounding to head-group integrality (Eq 5), then a
    capacity repair pass."""
    N, J = x.shape
    out: Placement = {}
    used = np.zeros(N)
    for j, r in enumerate(requests):
        frac = x[:, j] / r.group_ratio
        base = np.floor(frac + 1e-9).astype(int)
        rem = r.n_groups - int(base.sum())
        order = np.argsort(-(frac - base))
        for k in range(max(0, rem)):
            base[order[k % N]] += 1
        while base.sum() > r.n_groups:
            i = int(np.argmax(base))
            base[i] -= 1
        # capacity repair: move groups off over-full workers
        gb = r.group_ratio * r.kv_bytes_per_head()
        for i in range(N):
            while base[i] > 0 and used[i] + base[i] * gb > ws[i].free_bytes() + 1e-6:
                # find the worker with most slack
                slack = [(ws[k].free_bytes() - used[k] - base[k] * gb, k)
                         for k in range(N)]
                slack.sort(reverse=True)
                moved = False
                for s, k in slack:
                    if k != i and s >= gb:
                        base[i] -= 1
                        base[k] += 1
                        moved = True
                        break
                if not moved:
                    return None
        placement = {}
        for i in range(N):
            if base[i] > 0:
                placement[ws[i].device_id] = int(base[i] * r.group_ratio)
                used[i] += base[i] * gb
        out[r.rid] = placement
    return out


def apply_placement(workers: Sequence[WorkerState],
                    requests: Sequence[AttnRequest],
                    placement: Placement) -> None:
    """Commit a placement: update h_i, g_i (Eq 8) and request records."""
    by_id = {w.device_id: w for w in workers}
    reqs = {r.rid: r for r in requests}
    for rid, alloc in placement.items():
        r = reqs[rid]
        for dev, heads in alloc.items():
            w = by_id[dev]
            w.heads += heads
            w.cache_bytes += heads * r.kv_bytes_per_head()
        r.placement = dict(alloc)


def release_request(workers: Sequence[WorkerState], r: AttnRequest) -> None:
    by_id = {w.device_id: w for w in workers}
    for dev, heads in r.placement.items():
        w = by_id.get(dev)
        if w is None:
            continue
        w.heads -= heads
        w.cache_bytes -= heads * r.kv_bytes_per_head()
        w.heads = max(0.0, w.heads)
        w.cache_bytes = max(0.0, w.cache_bytes)
    r.placement = {}


def grow_context(workers: Sequence[WorkerState], r: AttnRequest,
                 new_tokens: int = 1) -> None:
    """Account one decode step: each placed head's cache grows."""
    by_id = {w.device_id: w for w in workers}
    per_head = new_tokens * r.kv_bytes_per_token_per_head()
    for dev, heads in r.placement.items():
        w = by_id.get(dev)
        if w is not None:
            w.cache_bytes += heads * per_head
    r.ctx_len += new_tokens


def current_attention_time(workers: Sequence[WorkerState], group_ratio: int,
                           head_dim: int, dtype_bytes: int = 2) -> float:
    ws = [w for w in _live(workers) if w.heads > 0 or w.cache_bytes > 0]
    if not ws:
        return 0.0
    return max(w.f_time(group_ratio, head_dim, dtype_bytes) for w in ws)


# ---------------------------------------------------------------------------
# Re-dispatching (§5.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RedispatchDecision:
    request: AttnRequest
    new_placement: Dict[int, int]
    migrated_bytes: float
    reason: str


def ideal_attention_time(workers: Sequence[WorkerState],
                         requests: Sequence[AttnRequest]) -> float:
    """f*: the min-max time if *all* live requests could be re-placed
    (paper §5.3.1, relaxed with the aggregate capacity constraint)."""
    ws = _live(workers)
    if not ws or not requests:
        return 0.0
    # Continuous relaxation: distribute total heads & bytes to equalize f_i.
    # Solve via the same LP with all requests and zeroed current load.
    # hypothetical zero-load copies: drop the physical-pool probe too —
    # the ideal bound assumes the pool would be re-packed from scratch
    blank = [dataclasses.replace(w, heads=0.0, cache_bytes=0.0,
                                 free_bytes_fn=None) for w in ws]
    x = _solve_relaxation(blank, list(requests)) if HAVE_SCIPY else None
    if x is None:
        x = _greedy_relaxation(blank, list(requests))
    # evaluate max f_i under x
    worst = 0.0
    for i, w in enumerate(blank):
        h = float(x[i].sum())
        g = float(sum(x[i, j] * r.kv_bytes_per_head()
                      for j, r in enumerate(requests)))
        r0 = requests[0]
        worst = max(worst, dataclasses.replace(
            w, heads=h, cache_bytes=g).f_time(r0.group_ratio, r0.head_dim,
                                              r0.dtype_bytes))
    return worst


def _ideal_lower_bound(ws: List[WorkerState],
                       requests: Sequence[AttnRequest]) -> float:
    """A lower bound on ``ideal_attention_time(ws, requests)`` for live
    ``ws``, without an LP.

    A head of request j costs w_ij = a_i + b_i s_j on blank worker i (s_j
    its K/V bytes a head), so for any lambda on the simplex
    L(lambda) = sum_i lambda_i c_i + sum_j H_j min_i lambda_i w_ij lies
    below the capacity-free LP's optimum (weak duality), which lies below
    f* (capacity only raises it; f* is max_i f_i of any x that places
    every head).  For two workers L is concave and piecewise linear in
    lambda_0, so its largest value, at 0, 1 or a kink w_1j / (w_0j +
    w_1j), is the optimum itself; for more, lambda_i goes as 1 / mean_j
    w_ij."""
    r0 = requests[0]
    a = np.array([w.eff_a(r0.group_ratio, r0.head_dim, r0.dtype_bytes)
                  for w in ws])
    b = np.array([w.eff_b() for w in ws])
    c = np.array([w.const() for w in ws])
    s = np.array([r.kv_bytes_per_head() for r in requests])
    heads = np.array([float(r.n_heads) for r in requests])
    cost = a[:, None] + b[:, None] * s[None, :]
    if len(ws) == 2:
        with np.errstate(divide="ignore", invalid="ignore"):
            t = cost[1] / (cost[0] + cost[1])
        t = np.concatenate(([0.0, 1.0], t[(t > 0.0) & (t < 1.0)]))
        lam = np.stack([t, 1.0 - t], axis=1)
    else:
        inv = 1.0 / cost.mean(axis=1)
        if not (np.isfinite(inv).all() and (inv > 0.0).all()):
            inv = np.ones(len(ws))
        lam = (inv / inv.sum())[None, :]
    bound = lam @ c + (lam[:, :, None] * cost[None]).min(axis=1) @ heads
    return float(bound.max())


ATTN_SNAPSHOT_PREFIX = "attn/device/"


def calibrate_from_snapshot(workers: Sequence[WorkerState],
                            snapshot: Dict[str, float],
                            group_ratio: int, head_dim: int,
                            dtype_bytes: int,
                            clamp: Tuple[float, float] = (0.25, 4.0)
                            ) -> None:
    """Fold measured per-device attention latency into the worker models.

    ``snapshot`` is a :meth:`MetricsRegistry.snapshot` dict whose
    ``attn/device/<id>`` gauges carry EWMA-smoothed *measured* attention
    time per device (the engine attributes its device-sync'd module-span
    durations across placed devices).  Each live worker's ``calib``
    becomes measured/analytic, clamped so one noisy sample cannot trigger
    a migration storm — this is what makes ``maybe_rebalance`` act on
    measured load rather than the static profile."""
    for w in _live(workers):
        meas = snapshot.get(f"{ATTN_SNAPSHOT_PREFIX}{w.device_id}")
        if meas is None or meas <= 0.0:
            continue
        w.calib = 1.0                        # analytic baseline for ratio
        analytic = w.f_time(group_ratio, head_dim, dtype_bytes)
        if analytic <= 0.0:
            continue
        w.calib = min(max(meas / analytic, clamp[0]), clamp[1])


def maybe_rebalance(workers: Sequence[WorkerState],
                    requests: Sequence[AttnRequest],
                    theta: float = 0.5,
                    snapshot: Optional[Dict[str, float]] = None
                    ) -> Optional[RedispatchDecision]:
    """§5.3.1: if current max time deviates from ideal by more than theta,
    re-dispatch the single request contributing most to the bottleneck.

    When a telemetry ``snapshot`` is given, measured per-device attention
    latency recalibrates every worker first, so both the trigger and the
    victim's new placement follow measured signals.  A current time within
    (1 + theta) of a lower bound on f* needs no LP to say no."""
    reqs = [r for r in requests if r.placement]
    if not reqs:
        return None
    r0 = reqs[0]
    if snapshot:
        calibrate_from_snapshot(workers, snapshot, r0.group_ratio,
                                r0.head_dim, r0.dtype_bytes)
    cur = current_attention_time(workers, r0.group_ratio, r0.head_dim,
                                 r0.dtype_bytes)
    live = _live(workers)
    if (live and 1.0 + theta > 0.0 and cur <= (1.0 + theta)
            * _ideal_lower_bound(live, reqs) * (1.0 - _EDGE)):
        SOLVES["bound"] += 1
        return None
    ideal = ideal_attention_time(workers, reqs)
    if ideal <= 0 or cur <= (1.0 + theta) * ideal:
        return None
    # bottleneck device
    ws = _live(workers)
    bottleneck = max(ws, key=lambda w: w.f_time(r0.group_ratio, r0.head_dim,
                                                r0.dtype_bytes))
    # request with the largest load on it (heads x ctx)
    victim = max((r for r in reqs if bottleneck.device_id in r.placement),
                 key=lambda r: r.placement[bottleneck.device_id] * r.ctx_len,
                 default=None)
    if victim is None:
        return None
    return _redispatch_one(workers, victim, reqs, reason="balance")


def _redispatch_one(workers: Sequence[WorkerState], victim: AttnRequest,
                    all_requests: Sequence[AttnRequest], reason: str
                    ) -> Optional[RedispatchDecision]:
    old = dict(victim.placement)
    release_request(workers, victim)
    placement = dispatch_lp(workers, [victim])
    if placement is None or victim.rid not in placement:
        # put it back
        apply_placement(workers, [victim], {victim.rid: old})
        return None
    new = placement[victim.rid]
    apply_placement(workers, [victim], {victim.rid: new})
    # §5.3: overlap reuse — heads staying on the same device do not move.
    moved_heads = 0
    for dev, heads in new.items():
        moved_heads += max(0, heads - old.get(dev, 0))
    migrated = moved_heads * victim.kv_bytes_per_head()
    return RedispatchDecision(victim, new, migrated, reason)


def handle_memory_exhaustion(workers: Sequence[WorkerState],
                             requests: Sequence[AttnRequest],
                             device_id: int,
                             theta: float = 0.5
                             ) -> Tuple[List[RedispatchDecision],
                                        List[AttnRequest]]:
    """§5.3 'Balance KV cache': device-local LIFO victim selection; the
    victim is re-dispatched if the cluster still has aggregate free space,
    otherwise it is preempted (returned in the evicted list)."""
    decisions: List[RedispatchDecision] = []
    evicted: List[AttnRequest] = []
    ws = _live(workers)
    dev = next((w for w in ws if w.device_id == device_id), None)
    if dev is None:
        return decisions, evicted
    # LIFO among requests that actually hold cache on this device (the
    # paper's fix to vLLM's device-agnostic preemption).
    local = [r for r in requests if device_id in r.placement]
    local.sort(key=lambda r: r.arrival, reverse=True)
    for victim in local:
        total_free = sum(w.free_bytes() for w in ws)
        if victim.total_kv_bytes() <= total_free:
            d = _redispatch_one(workers, victim, requests, reason="memory")
            if d is not None:
                decisions.append(d)
        else:
            release_request(workers, victim)
            evicted.append(victim)
        if dev.free_bytes() > 0:
            break
    return decisions, evicted


def handle_worker_failure(workers: Sequence[WorkerState],
                          requests: Sequence[AttnRequest],
                          device_id: int) -> Tuple[List[RedispatchDecision],
                                                   List[AttnRequest]]:
    """Beyond-paper fault tolerance: a lost attention worker's heads are
    re-dispatched among survivors (cache for those heads is recomputed or
    restored from checkpoint by the engine; here we re-place the load)."""
    for w in workers:
        if w.device_id == device_id:
            w.alive = False
            w.heads = 0.0
            w.cache_bytes = 0.0
    decisions, evicted = [], []
    for r in list(requests):
        if device_id not in r.placement:
            continue
        old = dict(r.placement)
        release_request(workers, r)
        placement = dispatch_lp(workers, [r])
        if placement is None:
            evicted.append(r)
            continue
        apply_placement(workers, [r], {r.rid: placement[r.rid]})
        moved = sum(max(0, h - old.get(d, 0))
                    for d, h in placement[r.rid].items())
        decisions.append(RedispatchDecision(r, placement[r.rid],
                                            moved * r.kv_bytes_per_head(),
                                            "failure"))
    return decisions, evicted
