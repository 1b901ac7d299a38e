"""The port's cluster simulator against the reference's: the same traces
from the same seeds, and the same ``SimResult`` from HetisSystem,
HexgenSystem and SplitwiseSystem on the trace of tests/test_sim.py (each
request's ttft and finish, ``duration``, ``timeline``, the p95 ttft / tpot
/ module latencies, throughput, normalised latency), HetisSystem's
failover (``fail_device``) and the saturating case of
tests/test_system.py.  Both packages run the same host arithmetic and the
same HiGHS LPs, so equality, not closeness.  Then the reference's own
property checks (tests/test_sim.py) run against the port."""

import math

import pytest

pytest.importorskip("torch")

from repro import sim as jsim
from repro.core import cluster as jcl
from repro.core import costmodel as jcm
from repro_torch import sim as tsim
from repro_torch.core import cluster as tcl
from repro_torch.core import costmodel as tcm

SYSTEMS = ("HetisSystem", "HexgenSystem", "SplitwiseSystem")


def same(a, b):
    """Equal, with NaN equal to NaN (an empty percentile)."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def result_key(res):
    """Every field and metric of a SimResult that the tests compare."""
    return dict(
        system=res.system, workload=res.workload, rate=res.rate,
        requests=[(r.rid, r.trace.arrival, r.trace.prompt_len,
                   r.trace.output_len, r.generated, r.prefilled, r.ttft,
                   r.finish) for r in res.finished],
        duration=res.duration, timeline=res.timeline,
        p95_ttft=res.p95_ttft(), p95_tpot=res.p95_tpot(),
        mean_tpot=res.mean_tpot(),
        p95_attention=res.p95_module("attention"),
        p95_mlp=res.p95_module("mlp"), throughput=res.throughput(),
        normalized_latency=res.normalized_latency(),
        served=[r.rid for r in res.served],
        spans=len(res.tracer.spans(track="sim")))


def assert_same_results(got, want):
    g, w = result_key(got), result_key(want)
    assert g.keys() == w.keys()
    for k in w:
        assert same(g[k], w[k]), k


def run(pkg_sim, pkg_cl, system, profile, trace_kw, sim_kw, cluster=None):
    cl = cluster or pkg_cl.ClusterSpec.paper_testbed()
    sys_ = getattr(pkg_sim, system)(profile, cl)
    trace = pkg_sim.make_trace(**trace_kw)
    return sys_, pkg_sim.simulate(sys_, trace, trace_kw["workload"],
                                  trace_kw["rate"], **sim_kw)


SHAREGPT = dict(workload="sharegpt", rate=1.5, duration=30, seed=0)


@pytest.fixture(scope="module")
def results():
    """tests/test_sim.py's runs (llama-70b, the paper testbed, sharegpt at
    1.5 req/s for 30 s) in both packages: {name: (ref, port)} of
    (system, result)."""
    out = {}
    for system in SYSTEMS:
        want = run(jsim, jcl, system, jcm.LLAMA_70B, SHAREGPT,
                   dict(max_sim_seconds=300))
        got = run(tsim, tcl, system, tcm.LLAMA_70B, SHAREGPT,
                  dict(max_sim_seconds=300))
        out[want[0].name] = (want, got)
    return out


@pytest.mark.parametrize("workload", ["sharegpt", "humaneval", "longbench"])
def test_traces_equal(workload):
    assert vars(tsim.WORKLOADS[workload]) == vars(jsim.WORKLOADS[workload])
    for rate, duration, seed in ((1.5, 30, 0), (5.0, 60, 1), (0.01, 1, 3)):
        want = jsim.make_trace(workload, rate, duration, seed)
        got = tsim.make_trace(workload, rate, duration, seed)
        assert [vars(t) for t in got] == [vars(t) for t in want]


@pytest.mark.parametrize("system", ["hetis", "hexgen", "splitwise"])
def test_sim_results_equal(results, system):
    (jsys, jres), (tsys, tres) = results[system]
    assert_same_results(tres, jres)
    assert tsys.kv_capacity_tokens() == jsys.kv_capacity_tokens()
    assert len(tres.finished) == len(tres.served) > 0
    if system == "hetis":
        assert [(w.device_id, w.heads, w.cache_bytes, w.capacity_bytes)
                for w in tsys.workers] \
            == [(w.device_id, w.heads, w.cache_bytes, w.capacity_bytes)
                for w in jsys.workers]
        assert (tsys.redispatches, tsys.evictions, tsys.migrated_bytes) \
            == (jsys.redispatches, jsys.evictions, jsys.migrated_bytes)


@pytest.mark.parametrize("variant", [
    dict(use_redispatch=False), dict(optimistic_admission=True),
    dict(model_error=0.2, seed=3)])
def test_hetis_options_equal(variant):
    """HetisSystem's switches: re-dispatching off, vLLM-style (prompt-only)
    admission, perturbed profiler models."""
    trace_kw = dict(workload="sharegpt", rate=3.0, duration=4, seed=4)
    out = []
    for pkg_sim, pkg_cl, cm in ((jsim, jcl, jcm), (tsim, tcl, tcm)):
        sys_ = pkg_sim.HetisSystem(cm.LLAMA_13B,
                                   pkg_cl.ClusterSpec.paper_testbed(),
                                   **variant)
        res = pkg_sim.simulate(sys_, pkg_sim.make_trace(**trace_kw),
                               "sharegpt", 3.0, max_sim_seconds=120)
        out.append((result_key(res), sys_.evictions, sys_.redispatches,
                    sys_.migrated_bytes))
    (jk, *jrest), (tk, *trest) = out
    assert trest == jrest
    for k in jk:
        assert same(tk[k], jk[k]), k


def test_failover_equal():
    """tests/test_sim.py::test_fault_tolerance_failover in both packages:
    the same simulation, then the first pool device fails."""
    trace_kw = dict(workload="sharegpt", rate=2.0, duration=10, seed=2)
    out = []
    for pkg_sim, pkg_cl, cm in ((jsim, jcl, jcm), (tsim, tcl, tcm)):
        sys_, res = run(pkg_sim, pkg_cl, "HetisSystem", cm.LLAMA_13B,
                        trace_kw, dict(max_sim_seconds=120))
        pool_dev = [w for w in sys_.workers if w.xfer is not None][0]
        evicted = sys_.fail_device(pool_dev.device_id)
        for ar in sys_.attn_reqs.values():
            assert pool_dev.device_id not in ar.placement
        out.append((res, evicted, pool_dev.device_id,
                    {rid: dict(ar.placement)
                     for rid, ar in sys_.attn_reqs.items()},
                    [(w.device_id, w.alive, w.heads, w.cache_bytes)
                     for w in sys_.workers],
                    (sys_.redispatches, sys_.evictions)))
    (jres, *jrest), (tres, *trest) = out
    assert_same_results(tres, jres)
    assert trest == jrest


def test_saturating_sim_equal():
    """The saturating traffic of tests/test_system.py::
    test_sim_saturates_gracefully (50 req/s for 3 s) in both packages,
    against a 10 s horizon that the run reaches with requests unserved
    (at that test's 30 s horizon every request is served by 21 s): the run
    must stop at the horizon, the same in both."""
    trace_kw = dict(workload="sharegpt", rate=50.0, duration=3.0, seed=0)
    jsys, jres = run(jsim, jcl, "HetisSystem", jcm.LLAMA_13B, trace_kw,
                     dict(max_sim_seconds=10.0))
    tsys, tres = run(tsim, tcl, "HetisSystem", tcm.LLAMA_13B, trace_kw,
                     dict(max_sim_seconds=10.0))
    assert tres.duration <= 11.0
    assert 0 < len(tres.served) < len(tsim.make_trace(**trace_kw))
    assert_same_results(tres, jres)


# ---- the reference's property checks (tests/test_sim.py) --------------
def hetis_beats_baselines_on_latency(r):
    h = r["hetis"][1].normalized_latency()
    assert r["hexgen"][1].normalized_latency() >= h * 0.95
    assert r["splitwise"][1].normalized_latency() > h


def hetis_has_most_cache(r):
    caps = {name: s.kv_capacity_tokens() for name, (s, _) in r.items()}
    assert caps["hetis"] > caps["hexgen"]
    assert caps["hetis"] > caps["splitwise"]


def all_requests_served(r):
    for name, (_, res) in r.items():
        assert len(res.served) == len(res.finished), name
        for q in res.served:
            assert q.ttft is not None and q.ttft >= 0
            assert q.finish >= q.trace.arrival


def splitwise_memory_inefficiency(r):
    assert (r["splitwise"][0].kv_capacity_tokens()
            < 0.5 * r["hetis"][0].kv_capacity_tokens())


def workload_stats(r):
    for wl, lo, hi in (("sharegpt", 150, 600), ("humaneval", 60, 300),
                       ("longbench", 4000, 13000)):
        tr = tsim.make_trace(wl, rate=5.0, duration=60, seed=1)
        assert lo < sum(t.prompt_len for t in tr) / len(tr) < hi, wl


def fault_tolerance_failover(r):
    sys_ = tsim.HetisSystem(tcm.LLAMA_13B, tcl.ClusterSpec.paper_testbed())
    tsim.simulate(sys_, tsim.make_trace("sharegpt", rate=2.0, duration=10,
                                        seed=2), "sharegpt", 2.0,
                  max_sim_seconds=120)
    pool_dev = [w for w in sys_.workers if w.xfer is not None][0]
    sys_.fail_device(pool_dev.device_id)
    for ar in sys_.attn_reqs.values():
        assert pool_dev.device_id not in ar.placement


CHECKS = {f.__name__: f for f in (
    hetis_beats_baselines_on_latency, hetis_has_most_cache,
    all_requests_served, splitwise_memory_inefficiency, workload_stats,
    fault_tolerance_failover)}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_reference_property_holds_in_the_port(results, check):
    CHECKS[check]({name: got for name, (_, got) in results.items()})
