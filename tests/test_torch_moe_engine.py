"""The port's engine serving MoE configs against the reference's engine,
in lockstep on the same requests, bridged weights and simulated cluster
(A100 primary + 3090 pool shard): the reduced dbrx under the fused step,
the split schedule and the dense prefill, each against its own
counterpart (capacity drops depend on the token count of each call, so
the modes are not compared with each other), and a two-group stack (a
dense layer, then MoE layers with a shared expert) under the fused step.
After every step the token streams, the queues, the counters, the pool
tables and the clock must be identical."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import serve_in_lockstep
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import get_config
from repro_torch.models import mlp as tmlp
from repro_torch.models.config import ModelConfig as TConfig

TWO_GROUPS = dict(name="tiny-moe2", family="moe", n_layers=3, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                  head_dim=16, n_experts=4, top_k=2, moe_d_ff=64,
                  first_dense_layers=1, n_shared_experts=1,
                  dtype="float32")
# one compiled call, not one per eager op
jax_init_params = jax.jit(JT.init_params, static_argnums=0)


@pytest.fixture
def moe_calls(monkeypatch):
    """``watch(cfg)``: a list gathering (T, dropped assignments) of every
    MoE pass the port makes from then on."""
    def watch(cfg):
        calls = []
        rank = tmlp._position_in_expert

        def record(flat_e, n_experts):
            pos = rank(flat_e, n_experts)
            T = flat_e.shape[0] // cfg.top_k
            calls.append((T, int((pos >= tmlp.moe_capacity(cfg, T)).sum())))
            return pos
        monkeypatch.setattr(tmlp, "_position_in_expert", record)
        return calls
    return watch


def serve_both(jcfg, tcfg, ecfg, n, lo, hi, seed=0):
    params = jax.tree.map(np.asarray,
                          jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    kw = dict(max_batch=8, max_seq=128, page_size=8, prefill_chunk=16)
    kw.update(ecfg)
    return serve_in_lockstep(jcfg, tcfg, params, kw, n, lo, hi, max_new=6,
                             seed=seed)


# (engine config, requests, prompt lengths [lo, hi)): the fused and split
# row batches reach 4 rows x 32 tokens = 128 > 64 token rows (the capped
# pass); the dense prefill's prompts pass 64 tokens
DBRX_MODES = {
    "fused": (dict(step_mode="fused", prefill_chunk=32), 4, 20, 60),
    "split": (dict(step_mode="split", prefill_chunk=32), 3, 30, 60),
    "dense_prefill": (dict(prefill_mode="dense"), 3, 60, 90),
}


@pytest.mark.parametrize("mode", sorted(DBRX_MODES))
def test_reduced_dbrx_serves_the_reference_tokens(mode, moe_calls):
    ecfg, n, lo, hi = DBRX_MODES[mode]
    jcfg = jget_config("dbrx-132b").reduced(vocab_size=128)
    tcfg = get_config("dbrx-132b").reduced(vocab_size=128)
    calls = moe_calls(tcfg)
    t = serve_both(jcfg, tcfg, ecfg, n, lo, hi)
    assert t.use_fused == (mode == "fused")
    # a pass over more than 64 token rows dropped assignments
    assert any(T > 64 and dropped for T, dropped in calls), sorted(set(calls))


def test_two_group_stack_serves_the_reference_tokens(moe_calls):
    jcfg, tcfg = JConfig(**TWO_GROUPS), TConfig(**TWO_GROUPS)
    calls = moe_calls(tcfg)
    t = serve_both(jcfg, tcfg, dict(step_mode="fused"), 3, 20, 60, seed=1)
    assert t.use_fused
    # the MoE group's two layers ran in every step
    assert len(calls) == 2 * t.metrics["steps"]
