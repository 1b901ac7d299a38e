"""The port's sigma* Parallelizer and elastic controller against the
reference's: the same ``ParallelPlan`` (each instance's stages with their
device ids, layers and tp, the pipeline depth, the attention pool and the
modeled cost; not ``search_seconds``, a wall-clock reading) on the
clusters of tests/test_parallelizer.py and tests/test_system.py and the
paper testbed, for the paper models and qwen3-14b; the search's helpers;
and ``ElasticController``'s plans and events through a fail/join
sequence.  Host arithmetic in both packages, so equality, not closeness.
Then the reference's own property checks run against the port."""

import time

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.core import cluster as jcl
from repro.core import costmodel as jcm
from repro.core import parallelizer as jpl
from repro.core.dispatcher import WorkerState as JWorker
from repro.core.profiler import analytic_attention_model as janalytic
from repro.distributed import fault_tolerance as jft
from repro_torch.configs import get_config as tget_config
from repro_torch.core import cluster as tcl
from repro_torch.core import costmodel as tcm
from repro_torch.core import parallelizer as tpl
from repro_torch.core.dispatcher import WorkerState as TWorker
from repro_torch.core.profiler import analytic_attention_model as tanalytic
from repro_torch.distributed import fault_tolerance as tft

CLUSTERS = {
    "paper_testbed": None,
    "test_system": [("A100", 2), ("3090", 2), ("P100", 2)],
    "two_classes": [("A100", 2), ("P100", 2)],
    "one_class": [("3090", 4)],
    "at_scale": ([("H100", 8)] * 4 + [("A100", 8)] * 4 + [("3090", 8)] * 4
                 + [("L4", 8)] * 4 + [("P100", 8)] * 4),
}
MODELS = sorted(jcm.PAPER_MODELS) + ["qwen3-14b"]
DISTS = {
    "test_parallelizer": dict(batch=25, prefill_len=512, decode_ctx=1000,
                              avg_output_len=128),
    "test_system": dict(batch=8, decode_ctx=512),
    "at_scale": dict(batch=200, decode_ctx=1000),
    "chip_smoke": dict(batch=16, prefill_len=580, decode_ctx=596,
                       avg_output_len=32),
}


def cluster(pkg, name):
    hosts = CLUSTERS[name]
    return (pkg.ClusterSpec.paper_testbed() if hosts is None
            else pkg.ClusterSpec.build(hosts))


def profiles(name):
    if name in jcm.PAPER_MODELS:
        return jcm.PAPER_MODELS[name], tcm.PAPER_MODELS[name]
    return jget_config(name).profile(), tget_config(name).profile()


def plan_key(plan):
    """Everything of a plan but its search time."""
    return ([[(tuple(d.device_id for d in s.devices), s.n_layers, s.tp,
               s.cls.name) for s in inst.stages] for inst in plan.instances],
            [d.device_id for d in plan.attention_workers],
            [d.device_id for d in plan.primary_workers], plan.cost,
            plan.summary())


def grid(cname):
    """(distribution name, delta) pairs searched on a cluster: the
    160-device cluster only at its own traffic and the default delta, as
    tests/test_parallelizer.py searches it."""
    if cname == "at_scale":
        return [("at_scale", 0.05)]
    return [(d, delta) for d in DISTS for delta in (0.0, 0.05, 0.5)]


@pytest.mark.parametrize("cname", sorted(CLUSTERS))
def test_search_plans_equal(cname):
    for model in MODELS:
        jp, tp = profiles(model)
        for dname, delta in grid(cname):
            kw = DISTS[dname]
            jr, tr = jpl.RequestDistribution(**kw), \
                tpl.RequestDistribution(**kw)
            try:
                want = plan_key(jpl.search(cluster(jcl, cname), jp, jr,
                                           delta))
            except AssertionError:           # no feasible plan
                with pytest.raises(AssertionError):
                    tpl.search(cluster(tcl, cname), tp, tr, delta)
                continue
            got = tpl.search(cluster(tcl, cname), tp, tr, delta)
            assert plan_key(got) == want, (model, dname, delta)
            assert got.search_seconds > 0.0


def test_search_helpers_equal():
    groups_list = [[("A100", 4), ("3090", 4), ("P100", 4)],
                   [("A100", 2), ("P100", 2)], [("A100", 2)],
                   [("H100", 1), ("L4", 3)], [("3090", 1)]]
    for model in MODELS:
        jp, tp = profiles(model)
        for kw in DISTS.values():
            jr, tr = jpl.RequestDistribution(**kw), \
                tpl.RequestDistribution(**kw)
            assert tr.scaled(0.5) == tpl.RequestDistribution(
                **vars(jr.scaled(0.5)))
            for groups in groups_list:
                layers = jpl.assign_layers(groups, jp.n_layers)
                assert tpl.assign_layers(groups, tp.n_layers) == layers
                assert tpl.c_p(groups, tp, tr) == jpl.c_p(groups, jp, jr)
                assert tpl.c_p(groups, tp, tr, layers) \
                    == jpl.c_p(groups, jp, jr, layers)
                for pool_gb in (0.0, 48.0):
                    assert tpl._kv_capacity_ok(groups, pool_gb, tp, tr,
                                               layers) \
                        == jpl._kv_capacity_ok(groups, pool_gb, jp, jr,
                                               layers)
            for cname in ("paper_testbed", "test_system"):
                jc, tc = cluster(jcl, cname), cluster(tcl, cname)
                for cls_name in ("A100", "3090", "P100"):
                    jd, td = jc.by_class()[cls_name], tc.by_class()[cls_name]
                    for L in (1, 7, 40):
                        want = jpl._expand_stage_tp_pp(jd, L, jp, jc, jr)
                        got = tpl._expand_stage_tp_pp(td, L, tp, tc, tr)
                        assert [(tuple(d.device_id for d in s.devices),
                                 s.n_layers) for s in got] \
                            == [(tuple(d.device_id for d in s.devices),
                                 s.n_layers) for s in want]
    assert tpl.c_p([], tcm.LLAMA_13B, tpl.RequestDistribution()) \
        == float("inf")
    for counts in ({"A100": 4, "3090": 4, "P100": 4}, {"A100": 2, "L4": 3},
                   {"H100": 8, "A100": 8, "P100": 8}):
        assert tpl._even_dp_choices(counts) == jpl._even_dp_choices(counts)


def test_plan_cost_equal():
    for model in MODELS:
        jp, tp = profiles(model)
        jc, tc = cluster(jcl, "paper_testbed"), cluster(tcl, "paper_testbed")
        jr = jpl.RequestDistribution(**DISTS["test_parallelizer"])
        tr = tpl.RequestDistribution(**DISTS["test_parallelizer"])
        jplan, tplan = jpl.search(jc, jp, jr), tpl.search(tc, tp, tr)
        assert tpl._plan_cost(tplan.instances, tp, tc, tr) \
            == jpl._plan_cost(jplan.instances, jp, jc, jr)


def controller_trace(ft, cl, p, r, worker_cls, analytic, model):
    """Plans and events of one elastic sequence: a pool device fails, the
    anchor primary fails, a 3090 fails, everything rejoins, then a
    straggler and a slow-but-normal step are observed."""
    ec = ft.ElasticController(cl.ClusterSpec.paper_testbed(), p, r)
    out = [plan_key(ec.plan)]
    anchor = ec.plan.primary_workers[0].device_id
    pool = ec.plan.attention_workers[-1].device_id
    for op, dev in (("fail", pool), ("fail", anchor), ("fail", 5),
                    ("fail", 5), ("join", anchor), ("join", 99),
                    ("join", pool), ("join", 5)):
        out.append((op, dev, plan_key(getattr(ec, op)(dev)),
                    sorted(ec.dead)))
    dc = cl.DEVICE_CLASSES["3090"]
    w = worker_cls(5, analytic(dc, model), None, 1e9)
    for pred, obs in ((1e-3, 2e-3), (1e-3, 1.1e-3), (0.0, 1.0)):
        ec.observe_step(w, pred, obs)
        out.append((w.attn.a, w.attn.b, w.attn.c))
    out.append([(e.kind, e.device_id, e.detail) for e in ec.events])
    return out


@pytest.mark.parametrize("model", MODELS)
def test_elastic_controller_equal(model):
    jp, tp = profiles(model)
    kw = DISTS["chip_smoke"]
    want = controller_trace(jft, jcl, jp, jpl.RequestDistribution(**kw),
                            JWorker, janalytic, jp)
    got = controller_trace(tft, tcl, tp, tpl.RequestDistribution(**kw),
                           TWorker, tanalytic, tp)
    assert got == want
    # the anchor's failure re-planned without it; once every device has
    # rejoined, the plan is the first one again
    anchor = want[0][2][0]
    assert anchor not in got[2][2][2]
    assert got[8][2] == got[0]


# ---- the reference's property checks (tests/test_parallelizer.py) -----
R = dict(batch=25, prefill_len=512, decode_ctx=1000, avg_output_len=128)


def paper_deployment_llama70b(pl, cl, cm):
    plan = pl.search(cl.ClusterSpec.paper_testbed(), cm.LLAMA_70B,
                     pl.RequestDistribution(**R))
    assert {d.cls.name for d in plan.attention_workers} == {"P100"}
    assert {d.cls.name for d in plan.primary_workers} == {"A100", "3090"}


def layer_assignment_sums_and_positivity(pl, cl, cm):
    layers = pl.assign_layers([("A100", 4), ("3090", 4), ("P100", 4)], 80)
    assert sum(layers) == 80
    assert all(x >= 1 for x in layers)
    assert layers[0] == max(layers)


def delta_controls_exclusion(pl, cl, cm):
    c = cl.ClusterSpec.paper_testbed()
    r = pl.RequestDistribution(**R)
    strict = pl.search(c, cm.LLAMA_70B, r, delta=0.0)
    loose = pl.search(c, cm.LLAMA_70B, r, delta=0.5)
    assert len(loose.attention_workers) >= len(strict.attention_workers)


def search_is_fast_at_scale(pl, cl, cm):
    big = cl.ClusterSpec.build(CLUSTERS["at_scale"])
    t0 = time.perf_counter()
    plan = pl.search(big, cm.LLAMA_70B,
                     pl.RequestDistribution(batch=200, decode_ctx=1000))
    assert time.perf_counter() - t0 < 15.0
    assert plan.primary_workers and plan.attention_workers


def cp_continuous_matches_total_power(pl, cl, cm):
    r = pl.RequestDistribution(**R)
    v = pl.c_p([("A100", 2), ("P100", 2)], cm.LLAMA_13B, r)
    assert pl.c_p([("A100", 2)], cm.LLAMA_13B, r) / v < 1.05


CHECKS = {f.__name__: f for f in (
    paper_deployment_llama70b, layer_assignment_sums_and_positivity,
    delta_controls_exclusion, search_is_fast_at_scale,
    cp_continuous_matches_total_power)}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_reference_property_holds_in_the_port(check):
    CHECKS[check](tpl, tcl, tcm)
