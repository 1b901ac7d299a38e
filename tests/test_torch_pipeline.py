"""The twin of tests/test_system.py::test_paper_pipeline_end_to_end:
Parallelizer -> Dispatcher -> engine on one stack, in both packages.  Both
plan the same cluster (2 A100, 2 3090, 2 P100) with the same sigma*
search; then the port's engine (reduced fp32 qwen3-14b on the CPU) serves
with the plan's primary and attention-pool roles in lockstep with the
reference's engine on the same weights: the same greedy tokens, queues,
counters, tables and clock after every step, every pool shard's contents
alike, and both caches' invariants."""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.core import costmodel as jcm
from repro.core import parallelizer as jpl
from repro.core.cluster import ClusterSpec as JCluster
from repro.models.transformer import init_params as jax_init_params
from repro_torch.configs import get_config as tget_config
from repro_torch.core import costmodel as tcm
from repro_torch.core import parallelizer as tpl
from repro_torch.core.cluster import ClusterSpec as TCluster

from _torch_engine_pair import assert_same, engine_pair, submit_requests

HOSTS = [("A100", 2), ("3090", 2), ("P100", 2)]
POOLS = dict(rtol=1e-5, atol=1e-5)


def plan_roles(pl, cl, cm):
    plan = pl.search(cl.build(HOSTS), cm.LLAMA_13B,
                     pl.RequestDistribution(batch=8, decode_ctx=512))
    assert plan.primary_workers
    primary = [d.device_id for d in plan.primary_workers]
    pool = [d.device_id for d in plan.attention_workers] or [len(
        cl.build(HOSTS)) - 1]
    return plan, primary, pool


@functools.cache
def reduced_model():
    """Reduced fp32 qwen3-14b in both packages and the reference's seeded
    weights as numpy (made once, by one jitted init)."""
    jcfg = jget_config("qwen3-14b").reduced(dtype="float32")
    tcfg = tget_config("qwen3-14b").reduced(dtype="float32")
    params = jax.jit(lambda key: jax_init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, params)


@functools.cache
def served(mode):
    """Both packages plan the cluster; both engines serve four requests
    with the plan's roles in lockstep under ``mode``, compared after every
    step.  Returns the drained (reference, port) engines, the plan's roles,
    the shards that held pages and, before the first step and after every
    step, both engines' ``_model_decode_time`` and the port's parts."""
    jplan, jprimary, jpool = plan_roles(jpl, JCluster, jcm)
    tplan, primary, pool = plan_roles(tpl, TCluster, tcm)
    assert (primary, pool, tplan.cost, tplan.summary()) \
        == (jprimary, jpool, jplan.cost, jplan.summary())
    jcfg, tcfg, params = reduced_model()
    j, t = engine_pair(jcfg, tcfg, params,
                       dict(max_batch=4, max_seq=64, step_mode=mode),
                       hosts=HOSTS, primary_ids=primary, pool_ids=pool)

    def decode_times():
        return (j._model_decode_time(), t._model_decode_time(),
                sum(t._model_decode_parts()), bool(j.attn_reqs))

    times = [decode_times()]
    submit_requests((j, t), tcfg.vocab_size, 4, 8, 9, 5, seed=1)
    held = set()
    for _ in range(200):
        if not (j.queue or j.running or j.prefilling):
            break
        j.step()
        t.step()
        assert_same(j, t)
        held.update(d for chain in t.kv.tables.values() for d, _ in chain)
        assert [w.heads for w in t.workers] == [w.heads for w in j.workers]
        times.append(decode_times())
    return j, t, primary, pool, held, times


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_planned_roles_serve_the_reference_tokens(mode):
    j, t, primary, pool, held, _ = served(mode)
    assert len(primary) + len(pool) > 2
    vocab = t.cfg.vocab_size
    assert len(t.finished) == 4
    assert all(len(r.output) == 5 and all(0 <= x < vocab for x in r.output)
               for r in t.finished)
    # the plan's roles were served: more than one shard held pages
    assert len(held) > 1, held
    assert sorted(t.kv.kpools) == sorted(primary + pool)
    for d in t.kv.kpools:
        # every slot but the sink (duplicate scatter writes land there)
        sink = t.kv.partitions[d].total
        for tp_, jp_ in ((t.kv.kpools, j.kv.kpools),
                         (t.kv.vpools, j.kv.vpools)):
            got, want = tp_[d].numpy(), np.asarray(jp_[d])
            assert got.shape == want.shape
            keep = np.arange(got.shape[1]) != sink
            np.testing.assert_allclose(got[:, keep], want[:, keep], **POOLS)
    t.kv.check_invariants()
    j.kv.check_invariants()


def test_model_decode_time_equal():
    """``InferenceEngine._model_decode_time`` (attention + dense modeled
    step seconds over every planned worker) in both engines before the
    first step and after every step of the split run, and its parts."""
    *_, times = served("split")
    assert times[0][:2] == (1e-4, 1e-4)
    for want, got, parts, _ in times:
        assert got == pytest.approx(want, rel=1e-12)
        assert got == parts
    assert sum(active for *_, active in times) > 0
