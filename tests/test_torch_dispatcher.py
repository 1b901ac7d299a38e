"""The port's dispatcher against the reference's on seeded instances: the
same placements from ``dispatch_lp`` (one request on loaded workers, and
batches on blank ones), the same ``maybe_rebalance`` decisions (none, or
the same victim, new placement and migrated bytes) and the same worker
state after each, on two and four workers of the paper's classes, with
loads below and past the re-dispatch trigger, capacity slack and binding,
and measured calibration (``calib != 1``).  The port settles the trigger
by a lower bound on f* and places one request by water level where those
are the LP's answers (``core.dispatcher.SOLVES`` counts which ran); both
packages run the same host arithmetic, so equality, not closeness."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import dispatcher as jd
from repro.core import profiler as jp
from repro_torch.core import dispatcher as td
from repro_torch.core import profiler as tp
from repro_torch.core.cluster import DEVICE_CLASSES
from repro_torch.core.costmodel import ModelProfile

# qwen3-14b's attention: 40 query heads over 8 K/V heads of 128
PROFILE = ModelProfile("qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
                       n_kv_heads=8, d_ff=17408, vocab_size=151936,
                       head_dim=128)
RATIO = PROFILE.n_heads // PROFILE.n_kv_heads
# the primary first, then attention workers behind the network
CLASSES = ("A100", "3090", "P100", "L4")
INSTANCES = 10
THETA = 0.5


def workers(n, caps):
    """(the reference's workers, the port's): the first ``n`` of
    ``CLASSES`` with their analytic models and capacities ``caps``."""
    out = []
    for pkg, prof in ((jd, jp), (td, tp)):
        ws = []
        for i, name in enumerate(CLASSES[:n]):
            cls = DEVICE_CLASSES[name]
            m = tp.analytic_attention_model(cls, PROFILE)
            x = (None if i == 0 else
                 tp.analytic_transfer_model(cls.inter_link_gbps))
            ws.append(pkg.WorkerState(
                i, prof.AttentionModel(m.a, m.b, m.c),
                None if x is None else prof.TransferModel(x.gamma, x.beta),
                capacity_bytes=float(caps[i])))
        out.append(ws)
    return out


def requests(rng, j):
    """The same ``j`` requests in each package, contexts of 16-3000."""
    ctx = rng.integers(16, 3000, j)
    return [[pkg.AttnRequest(rid=k, ctx_len=int(ctx[k]),
                             n_heads=PROFILE.n_heads, group_ratio=RATIO,
                             head_dim=PROFILE.head_dim, dtype_bytes=2,
                             arrival=float(k)) for k in range(j)]
            for pkg in (jd, td)]


def state(w):
    return [(x.device_id, x.heads, x.cache_bytes, x.calib, x.alive)
            for x in w]


def decision(d):
    return None if d is None else (d.request.rid, d.new_placement,
                                   d.migrated_bytes, d.reason)


def solves():
    return dict(td.SOLVES)


def spent(mark):
    return {k: td.SOLVES[k] - v for k, v in mark.items()}


def build(rng, n, load, cap):
    """One seeded instance: its workers, its placed requests and the
    measured snapshot its check reads (or None).

    ``load``: ``below`` places each request in turn by ``dispatch_lp`` and
    decodes a few tokens; ``past`` puts every head on the last worker
    (the 3090, or the L4).
    ``cap``: ``slack`` leaves each worker every request's bytes;
    ``binding`` leaves the primary a fifth of them."""
    j = int(rng.integers(1, 33))
    jr, tr = requests(rng, j)
    need = sum(r.total_kv_bytes() for r in jr)
    caps = [need * 4.0] * n
    if cap == "binding":
        caps[0] = need * 0.2
    jw, tw = workers(n, caps)
    mark = solves()
    if load == "below":
        for a, b in zip(jr, tr):
            pj, pt = jd.dispatch_lp(jw, [a]), td.dispatch_lp(tw, [b])
            assert pt == pj
            jd.apply_placement(jw, [a], pj)
            td.apply_placement(tw, [b], pt)
        for a, b in zip(jr, tr):
            grow = int(rng.integers(0, 200))
            jd.grow_context(jw, a, grow)
            td.grow_context(tw, b, grow)
    else:
        slow = n - 1
        for a, b in zip(jr, tr):
            jd.apply_placement(jw, [a], {a.rid: {slow: a.n_heads}})
            td.apply_placement(tw, [b], {b.rid: {slow: b.n_heads}})
    assert state(tw) == state(jw)
    snap = None
    if rng.random() < 0.5:
        # measured attention times off the analytic ones by up to 2x
        snap = {}
        for w in tw:
            f = w.f_time(RATIO, PROFILE.head_dim, 2)
            snap[f"{td.ATTN_SNAPSHOT_PREFIX}{w.device_id}"] = float(
                f * rng.uniform(0.5, 2.0))
    return jw, tw, jr, tr, snap, spent(mark)


@pytest.mark.parametrize("cap", ["slack", "binding"])
@pytest.mark.parametrize("load", ["below", "past"])
@pytest.mark.parametrize("n", [2, 4])
def test_dispatcher_decisions_match_the_reference(n, load, cap):
    rng = np.random.default_rng([n, len(load), len(cap)])
    placed = checked = by_bound = 0
    for _ in range(INSTANCES):
        jw, tw, jr, tr, snap, spent_build = build(rng, n, load, cap)
        placed += spent_build["water"]
        if snap:
            for pkg, ws in ((jd, jw), (td, tw)):
                pkg.calibrate_from_snapshot(ws, snap, RATIO,
                                            PROFILE.head_dim, 2)
            assert state(tw) == state(jw)
            assert any(w.calib != 1.0 for w in tw)
        # the bound lies below f* (to the last digits of the two sums,
        # far inside the check's margin), and for two workers with slack
        # capacity it is f* (the capacity-free LP's optimum)
        bound = td._ideal_lower_bound(td._live(tw), tr)
        fstar = jd.ideal_attention_time(jw, jr)
        assert bound <= fstar * (1.0 + 1e-12)
        if n == 2 and cap == "slack":
            assert bound == pytest.approx(fstar, rel=1e-6)
        cur = td.current_attention_time(tw, RATIO, PROFILE.head_dim, 2)
        mark = solves()
        dj = jd.maybe_rebalance(jw, jr, theta=THETA, snapshot=snap)
        dt = td.maybe_rebalance(tw, tr, theta=THETA, snapshot=snap)
        used = spent(mark)
        assert decision(dt) == decision(dj)
        assert state(tw) == state(jw)
        assert [r.placement for r in tr] == [r.placement for r in jr]
        checked += 1
        if cur <= (1.0 + THETA) * bound * (1.0 - td._EDGE):
            # settled without an LP: no, as the reference's LP says
            assert dj is None and used == {"lp": 0, "bound": 1, "water": 0}
            by_bound += 1
        else:
            # the LP decides whenever the bound cannot
            assert used["lp"] >= 1 and used["bound"] == 0
        if n == 2 and cap == "slack" and cur <= (1.0 + THETA) * fstar * (
                1.0 - 1e-5):
            assert used["bound"] == 1
        if cur > (1.0 + THETA) * fstar:
            assert dj is not None
        # a batch on blank workers stays HiGHS's
        jb, tb = workers(n, [w.capacity_bytes for w in tw])
        jr2, tr2 = requests(rng, len(jr))
        mark = solves()
        assert td.dispatch_lp(tb, tr2) == jd.dispatch_lp(jb, jr2)
        assert spent(mark)["water"] <= (len(tr2) == 1)
    if load == "below":
        # single placements by water level while capacity is slack, by
        # HiGHS where the primary's capacity binds
        assert placed > 0
    if load == "below" and cap == "slack":
        assert by_bound > 0
    if load == "past":
        assert by_bound < checked


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_one_request_placed_by_water_level_or_highs(n):
    """``dispatch_lp`` of one request on workers loaded by earlier
    placements, some since released: the reference's placement every
    time; by water level where its optimum is unique and capacity slack,
    by HiGHS where the primary's free bytes would overflow."""
    rng = np.random.default_rng(100 + n)
    water = lp = 0
    for k in range(24):
        jr, tr = requests(rng, int(rng.integers(1, 14)))
        jw, tw = workers(n, [sum(r.total_kv_bytes() for r in jr) * 2.0] * n)
        calib = float(rng.choice([1.0, 0.7, 1.6]))
        for a, b in zip(jw, tw):
            a.calib = b.calib = calib if a.device_id == 0 else 1.0
        for a, b in zip(jr, tr):
            pj, pt = jd.dispatch_lp(jw, [a]), td.dispatch_lp(tw, [b])
            assert pt == pj
            jd.apply_placement(jw, [a], pj)
            td.apply_placement(tw, [b], pt)
        for a, b in zip(jr[:-1], tr[:-1]):
            if rng.random() < 0.4:
                jd.release_request(jw, a)
                td.release_request(tw, b)
        a, b = jr[-1], tr[-1]
        jd.release_request(jw, a)
        td.release_request(tw, b)
        binding = n > 1 and k % 3 == 0
        if binding:
            for w in (jw[0], tw[0]):
                w.capacity_bytes = w.cache_bytes + 0.3 * a.total_kv_bytes()
        assert state(tw) == state(jw)
        mark = solves()
        pt = td.dispatch_lp(tw, [b])
        assert pt == jd.dispatch_lp(jw, [a])
        used = spent(mark)
        assert used["water"] + used["lp"] == 1 and not used["bound"]
        water += used["water"]
        lp += used["lp"]
        if binding and used["water"]:
            # the water level left the primary's free bytes unfilled
            x = td._water_fill(td._live(tw), b)[:, 0]
            assert (x * b.kv_bytes_per_head()
                    < np.array([w.free_bytes() for w in tw])).all()
    assert water > 0
    if n > 1:
        assert lp > 0
