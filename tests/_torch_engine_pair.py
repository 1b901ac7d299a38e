"""The reference's engine and the port's in lockstep, for the port's
parity tests: the same requests, the same weights (the reference's, handed
to the port through the bridge) and the same simulated cluster (by
default an A100 primary + a 3090 pool shard).  After every step the token
streams, the queues, the counters, the pool tables and the clock must be
identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.cluster import ClusterSpec as JCluster
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.core.cluster import ClusterSpec as TCluster
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import InferenceEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.weights import from_jax_params

HOSTS = [("A100", 1), ("3090", 1)]
COUNTERS = ["model_calls", "fused_steps", "prefill_chunks", "redispatches",
            "evictions", "steps", "h2d_bytes", "d2h_bytes",
            "prefill_h2d_bytes"]


def assert_same(j, t):
    assert {r.rid: r.output for r in t.finished} \
        == {r.rid: r.output for r in j.finished}
    for q in ("running", "prefilling", "queue"):
        assert [r.rid for r in getattr(t, q)] \
            == [r.rid for r in getattr(j, q)], q
    for k in COUNTERS:
        assert t.metrics[k] == j.metrics[k], k
    assert t.kv.tables == j.kv.tables
    assert t.clock == pytest.approx(j.clock, rel=1e-12)


def engine_pair(jcfg, tcfg, params_np, ecfg, hosts=HOSTS,
                primary_ids=(0,), pool_ids=(1,)):
    """Both engines built with ``EngineConfig(**ecfg)`` on the same
    weights and cluster (``ClusterSpec.build(hosts)``, the given roles):
    (the reference's, the port's on the CPU)."""
    j = JEngine(jcfg, jax.tree.map(jnp.asarray, params_np),
                JCluster.build(hosts), primary_ids=list(primary_ids),
                pool_ids=list(pool_ids), engine_cfg=JEngineConfig(**ecfg))
    t = TEngine(tcfg, from_jax_params(tcfg, params_np, device="cpu"),
                TCluster.build(hosts), primary_ids=list(primary_ids),
                pool_ids=list(pool_ids), engine_cfg=TEngineConfig(**ecfg),
                device="cpu")
    assert (t.use_fused, t.use_paged, t.use_paged_prefill) \
        == (j.use_fused, j.use_paged, j.use_paged_prefill)
    return j, t


def submit_requests(engines, vocab_size, n, lo, hi, max_new, seed=0):
    """The same ``n`` requests (prompts of [lo, hi) tokens drawn from
    ``seed``, ``max_new`` new tokens each) to every engine; each engine
    package's own ``Request``."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        prompt = [int(x) for x in rng.integers(0, vocab_size,
                                               rng.integers(lo, hi))]
        for eng in engines:
            req = JRequest if isinstance(eng, JEngine) else TRequest
            eng.submit(req(rid=i, prompt=list(prompt),
                           max_new_tokens=max_new))


def serve_in_lockstep(jcfg, tcfg, params_np, ecfg, n, lo, hi, max_new,
                      seed=0):
    """Serve ``n`` requests (prompts of [lo, hi) tokens drawn from
    ``seed``, ``max_new`` new tokens each) on both engines built with
    ``EngineConfig(**ecfg)``, comparing them after every step.  Returns
    the port's engine, drained."""
    j, t = engine_pair(jcfg, tcfg, params_np, ecfg)
    submit_requests((j, t), tcfg.vocab_size, n, lo, hi, max_new, seed)
    for _ in range(200):
        if not (j.queue or j.running or j.prefilling):
            break
        j.step()
        t.step()
        assert_same(j, t)
    assert len(t.finished) == n
    assert all(len(r.output) == max_new for r in t.finished)
    t.kv.check_invariants()
    # the port settled re-dispatch checks without the reference's LP
    assert t.snapshot("dispatch/")["dispatch/lp_avoided_check"] > 0
    return t
