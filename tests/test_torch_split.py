"""The port's split schedule (one prefill-chunk call and one decode call per
step) against the reference's on the same requests, bridged weights and
simulated cluster (A100 primary + 3090 pool shard), with cross-pool
migrations, LIFO preemptions and memory exhaustion interleaved: token
streams, counters, per-device occupancy and distinct step shapes must be
identical.  Then the port's twins of the reference's bucket guards, its
calls per step, and split tokens == fused tokens."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import (HOSTS, SPEC, TCFG, TPARAMS, assert_same,
                               make_pair, submit_both)
from repro_torch.core.cluster import ClusterSpec as TCluster
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import InferenceEngine as TEngine
from repro_torch.serving import Request as TRequest


def assert_same_split(j, t):
    assert_same(j, t)
    assert t.decode_compile_count() == j.decode_compile_count()
    assert t.prefill_compile_count() == j.prefill_compile_count()
    assert t._decode_shapes == j._decode_shapes
    assert t._prefill_shapes == j._prefill_shapes


def test_split_migration_and_preemption_interleaved():
    j, t = make_pair(step_mode="split")
    assert not t.use_fused and t.use_paged and t.use_paged_prefill
    submit_both(j, t, 5, seed=3, lo=6, hi=30, max_new=8)
    for _ in range(3):
        j.step()
        t.step()
    assert_same_split(j, t)
    movers = [r.rid for r in j.running][:2]
    assert movers
    for eng in (j, t):
        for rid in movers:
            eng._apply_migration(rid, {1: SPEC["n_heads"]})
    assert_same_split(j, t)
    assert t.snapshot()["migrate/d2d_bytes"] > 0
    victims = [r.rid for r in j.running if r.output][:2]
    assert victims
    for eng in (j, t):
        for rid in victims:
            eng._preempt(next(r for r in eng.running if r.rid == rid))
    assert_same_split(j, t)
    assert j.run_until_drained(400) and t.run_until_drained(400)
    assert len(t.finished) == 5
    t.kv.check_invariants()
    assert_same_split(j, t)
    assert t.metrics["fused_steps"] == 0
    assert t.metrics["model_calls"] > t.metrics["steps"]


def test_split_memory_exhaustion_redispatch_and_eviction():
    """Caches too small for the load: §5.3 exhaustion handling in the
    decode call's reservation migrates and evicts mid-run on both engines
    alike."""
    cap = 14 * 2 * 8 * 16 * 4 * 2 * 2 / 1e9      # ~14 slots per device
    j, t = make_pair(step_mode="split", cache_gb_per_device={0: cap, 1: cap})
    submit_both(j, t, 6, seed=11, lo=14, hi=30, max_new=6)
    for _ in range(400):
        if not (j.queue or j.running or j.prefilling):
            break
        j.step()
        t.step()
        assert_same_split(j, t)
    assert len(t.finished) == 6
    assert t.metrics["evictions"] + t.metrics["redispatches"] > 0
    t.kv.check_invariants()


def test_admission_overflows_max_batch_as_the_reference_does():
    """``_try_admit`` counts running and prefilling requests against
    ``max_batch`` but not the ones admitted in the same call, so a burst
    is admitted whole and the first prefill call's batch bucket exceeds
    ``max_batch`` (outside ``prefill_bucket_shapes()``).  The port keeps
    the reference's behaviour (ROADMAP Queue C): same shapes, same
    tokens."""
    j, t = make_pair(step_mode="split", max_batch=2)
    submit_both(j, t, 5, seed=5, lo=2, hi=8, max_new=1)
    j.step()
    t.step()
    assert_same_split(j, t)
    assert max(b for b, _, _, _ in t._prefill_shapes) == 8 > 2


def make_engine(**ecfg):
    kw = dict(max_batch=8, max_seq=96, page_size=8, prefill_chunk=8)
    kw.update(ecfg)
    return TEngine(TCFG, TPARAMS, TCluster.build(HOSTS), primary_ids=[0],
                   pool_ids=[1], engine_cfg=TEngineConfig(**kw),
                   device="cpu")


def random_prompt(rng, lo, hi):
    return [int(x) for x in rng.integers(0, SPEC["vocab_size"],
                                         rng.integers(lo, hi))]


def test_split_decode_shapes_stay_within_bucket_count():
    """Trickled arrivals over 60 steps keep the decode batch changing;
    the distinct decode-call shapes stay within ``bucket_count()``."""
    eng = make_engine(step_mode="split")
    rng = np.random.default_rng(7)
    rid = 0
    for step in range(60):
        if rid < 12 and step % 5 == 0:
            for _ in range(int(rng.integers(1, 4))):
                eng.submit(TRequest(rid=rid, prompt=random_prompt(rng, 4, 10),
                                    max_new_tokens=int(rng.integers(3, 9))))
                rid += 1
        eng.step()
    assert eng.metrics["steps"] == 60
    assert eng.decode_compile_count() <= eng.bucket_count()
    assert len(eng._decode_shapes) >= 2
    assert eng._decode_shapes <= set(eng.decode_bucket_shapes())


def test_split_prefill_shapes_stay_within_prefill_bucket_count():
    """30 varied-length one-token requests: the distinct prefill-chunk
    shapes stay within ``prefill_bucket_count()``."""
    eng = make_engine(step_mode="split", max_seq=64)
    rng = np.random.default_rng(11)
    for i in range(30):
        eng.submit(TRequest(rid=i, prompt=random_prompt(rng, 1, 25),
                            max_new_tokens=1))
    assert eng.run_until_drained(600)
    assert len(eng.finished) == 30
    assert eng.metrics["prefill_chunks"] > 0
    assert eng.prefill_compile_count() <= eng.prefill_bucket_count()
    assert len(eng._prefill_shapes) >= 2
    assert eng.metrics["prefill_h2d_bytes"] > 0
    assert eng.metrics["ttft_p95"] >= eng.metrics["ttft_p50"] > 0


def test_calls_per_step_and_split_tokens_equal_fused_tokens():
    """Fused issues one model call per step, split up to two; both emit
    the same token streams (a finished prefill row only starts decoding
    one step earlier under split)."""
    rng = np.random.default_rng(6)
    prompts = [random_prompt(rng, 3, 25) for _ in range(4)]
    outs = {}
    for mode in ("fused", "split"):
        eng = make_engine(step_mode=mode)
        for i, p in enumerate(prompts):
            eng.submit(TRequest(rid=i, prompt=list(p), max_new_tokens=5))
        assert eng.run_until_drained(400)
        outs[mode] = {r.rid: r.output for r in eng.finished}
        m = eng.metrics
        if mode == "fused":
            assert m["model_calls"] == m["steps"] == m["fused_steps"]
        else:
            assert m["model_calls"] > m["steps"]
            assert m["fused_steps"] == 0
    assert outs["split"] == outs["fused"]
    assert len(outs["split"]) == 4
