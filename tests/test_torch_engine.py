"""The port's fused-step engine against the reference's on the same
requests, the same bridged weights and the same simulated cluster
(A100 primary + 3090 pool shard): cross-pool migrations and LIFO
preemptions forced mid-run, and memory exhaustion under tight caches.
Token streams, the listed counters and the per-device pool occupancy must
be identical."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cluster import ClusterSpec as JCluster
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.core.cluster import ClusterSpec as TCluster
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import InferenceEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.weights import from_jax_params

SPEC = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
            dtype="float32", qk_norm=True)
JCFG, TCFG = JConfig(**SPEC), TConfig(**SPEC)
JPARAMS = JT.init_params(JCFG, jax.random.PRNGKey(0))
TPARAMS = from_jax_params(TCFG, jax.tree.map(np.asarray, JPARAMS),
                          device="cpu")
HOSTS = [("A100", 1), ("3090", 1)]
COUNTERS = ["model_calls", "fused_steps", "prefill_chunks", "redispatches",
            "evictions", "steps", "h2d_bytes", "d2h_bytes",
            "prefill_h2d_bytes"]
SNAP_KEYS = ["migrate/d2d_bytes", "migrate/partial",
             "fastpath/gather_d2d_bytes", "kv/device/0/used_slots",
             "kv/device/1/used_slots"]


def make_pair(**ecfg):
    kw = dict(max_batch=8, max_seq=96, page_size=8, prefill_chunk=8)
    kw.update(ecfg)
    j = JEngine(JCFG, JPARAMS, JCluster.build(HOSTS), primary_ids=[0],
                pool_ids=[1], engine_cfg=JEngineConfig(**kw))
    t = TEngine(TCFG, TPARAMS, TCluster.build(HOSTS), primary_ids=[0],
                pool_ids=[1], engine_cfg=TEngineConfig(**kw), device="cpu")
    return j, t


def submit_both(j, t, n, seed, lo, hi, max_new):
    rng = np.random.default_rng(seed)
    for i in range(n):
        prompt = [int(x) for x in rng.integers(0, SPEC["vocab_size"],
                                               rng.integers(lo, hi))]
        j.submit(JRequest(rid=i, prompt=list(prompt),
                          max_new_tokens=max_new))
        t.submit(TRequest(rid=i, prompt=list(prompt),
                          max_new_tokens=max_new))


def assert_same(j, t):
    assert {r.rid: r.output for r in t.finished} \
        == {r.rid: r.output for r in j.finished}
    assert [r.rid for r in t.running] == [r.rid for r in j.running]
    assert [r.rid for r in t.prefilling] == [r.rid for r in j.prefilling]
    assert [r.rid for r in t.queue] == [r.rid for r in j.queue]
    for k in COUNTERS:
        assert t.metrics[k] == j.metrics[k], k
    sj, st = j.snapshot(), t.snapshot()
    for k in SNAP_KEYS:
        assert st[k] == sj[k], k
    assert t.kv.tables == j.kv.tables
    assert t.clock == pytest.approx(j.clock, rel=1e-12)


def test_migration_and_preemption_interleaved():
    j, t = make_pair()
    submit_both(j, t, 5, seed=3, lo=6, hi=30, max_new=8)
    for _ in range(3):
        j.step()
        t.step()
    assert_same(j, t)
    movers = [r.rid for r in j.running][:2]
    assert movers
    for eng in (j, t):
        for rid in movers:
            eng._apply_migration(rid, {1: SPEC["n_heads"]})
    assert_same(j, t)
    assert t.snapshot()["migrate/d2d_bytes"] > 0
    victims = [r.rid for r in j.running if r.output][:2]
    assert victims
    for eng in (j, t):
        for rid in victims:
            eng._preempt(next(r for r in eng.running if r.rid == rid))
    assert_same(j, t)
    assert j.run_until_drained(400) and t.run_until_drained(400)
    assert len(t.finished) == 5
    t.kv.check_invariants()
    assert_same(j, t)
    assert t.fused_compile_count() <= t.fused_bucket_count()


def test_memory_exhaustion_redispatch_and_eviction():
    """Caches too small for the load: §5.3 exhaustion handling migrates
    and evicts mid-run on both engines alike."""
    cap = 14 * 2 * 8 * 16 * 4 * 2 * 2 / 1e9      # ~14 slots per device
    j, t = make_pair(cache_gb_per_device={0: cap, 1: cap})
    submit_both(j, t, 6, seed=11, lo=14, hi=30, max_new=10)
    for _ in range(400):
        if not (j.queue or j.running or j.prefilling):
            break
        j.step()
        t.step()
        assert_same(j, t)
    assert len(t.finished) == 6
    assert t.metrics["evictions"] + t.metrics["redispatches"] > 0
    t.kv.check_invariants()
