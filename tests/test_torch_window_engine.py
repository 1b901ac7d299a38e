"""The engine on a sliding-window GQA config, the reduced qwen3-14b with
``sliding_window=16`` on both layers, against the reference's engine on
bridged weights.  Both engines serve it by the dense route whatever the
modes (their paged paths take no window): the serial dense prefill
(``transformer.prefill``, B3 with the window) and dense decode
(``decode_step`` with the layer's window) under the split schedule.

Prompts of at most 32 tokens (the reduced config's ``scan_q_chunk``) run
in lockstep, a migration and a preemption interleaved: tokens, counters,
pool occupancy, tables and the clock equal after every step.  Past 32
tokens, at 37, the reference's chunked attention reads the wrong keys in
its last strip (``repro/models/common.py:150-183``, ROADMAP Queue C);
there the port's engine equals its own plain ``prefill`` +
``decode_step`` re-run and the reference's differs."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import engine_pair, submit_requests
from test_torch_engine import assert_same
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as T
from repro_torch.serving import Request as TRequest
from repro_torch.weights import from_jax_params

WINDOW = 16
JCFG = dataclasses.replace(jget_config("qwen3-14b").reduced(),
                           sliding_window=WINDOW)
TCFG = dataclasses.replace(smoke_config("qwen3-14b"), sliding_window=WINDOW)
PARAMS = jax.tree.map(np.asarray, JT.init_params(JCFG, jax.random.PRNGKey(0)))
ECFG = dict(max_batch=4, max_seq=64, page_size=8, prefill_chunk=8)
MODES = {"default": {},
         "dense/dense/split": dict(prefill_mode="dense", decode_mode="dense",
                                   step_mode="split")}


def test_the_reduced_config_keeps_its_window_on_one_layer_group():
    assert JCFG.scan_q_chunk == 32 and TCFG.n_layers == 2
    assert T.layer_groups(TCFG) == [("gqa_mlp", 2, WINDOW)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lo, hi", [(5, WINDOW), (WINDOW + 1, 27)],
                         ids=["inside", "past"])
def test_windowed_engine_in_lockstep_with_the_reference(mode, lo, hi):
    """Four requests (prompts of [lo, hi) tokens, 8 new tokens each, so
    every context passes the window); after 3 steps one request's heads
    migrate to the pool shard and another is preempted (it replays its
    prompt and output through the dense prefill: at most 32 tokens, as
    the prompts stay under 27)."""
    j, t = engine_pair(JCFG, TCFG, PARAMS, dict(ECFG, **MODES[mode]))
    assert (t.use_paged, t.use_paged_prefill, t.use_fused) \
        == (False, False, False)
    submit_requests((j, t), TCFG.vocab_size, 4, lo, hi, 8, seed=lo)
    for step in range(200):
        if not (j.queue or j.running or j.prefilling):
            break
        j.step()
        t.step()
        assert_same(j, t)
        if step == 2:
            rids = [r.rid for r in j.running]
            assert len(rids) >= 2
            for eng in (j, t):
                eng._apply_migration(rids[0], {1: TCFG.n_heads})
                victim = next(r for r in eng.running if r.rid == rids[1])
                assert len(victim.prompt + victim.output) <= 32
                eng._preempt(victim)
            assert_same(j, t)
    assert len(t.finished) == 4
    assert all(len(r.output) == 8 for r in t.finished)
    assert t.snapshot()["migrate/d2d_bytes"] > 0
    assert t.metrics["prefill_chunks"] == 0          # no paged call ran
    t.kv.check_invariants()


def plain_greedy(prompt, new_tokens):
    """The port's model functions alone: one ``prefill`` of the prompt,
    then ``decode_step``s on its dense cache, greedy."""
    params = from_jax_params(TCFG, PARAMS, device="cpu")
    logits, cache = T.prefill(TCFG, params, {"tokens": torch.tensor(
        [prompt], dtype=torch.int32)}, max_seq=ECFG["max_seq"])
    out = [int(logits[0].argmax())]
    while len(out) < new_tokens:
        logits, cache = T.decode_step(TCFG, params, cache, torch.tensor(
            [[out[-1]]], dtype=torch.int32))
        out.append(int(logits[0].argmax()))
    return out


def test_past_the_strip_the_port_keeps_the_masked_function():
    """37-token prompts: the port's engine emits its own plain re-run's
    tokens; the reference's engine does not (its static-window strip reads
    keys its mask did not mean, from the first token on)."""
    rng = np.random.default_rng(37)
    prompts = [[int(x) for x in rng.integers(0, TCFG.vocab_size, 37)]
               for _ in range(2)]
    j, t = engine_pair(JCFG, TCFG, PARAMS, ECFG)
    for eng, req in ((j, JRequest), (t, TRequest)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=list(p), max_new_tokens=6))
    assert j.run_until_drained(200) and t.run_until_drained(200)
    got = {r.rid: r.output for r in t.finished}
    ref = {r.rid: r.output for r in j.finished}
    for i, p in enumerate(prompts):
        assert got[i] == plain_greedy(p, 6)
        assert ref[i][0] != got[i][0]



@pytest.mark.parametrize("name", ["hymba-1.5b", "deepseek-v3-671b",
                                  "xlstm-350m", "internvl2-1b",
                                  "hubert-xlarge"])
def test_the_families_the_reference_engine_fails_on_are_refused(name):
    """hymba (SSM hybrid, windows beside global layers), deepseek-v3
    (MLA), xLSTM and the stub frontends: the reference's engine fails on
    each, the port's refuses it."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import InferenceEngine
    with pytest.raises(NotImplementedError, match="ROADMAP Queue C"):
        InferenceEngine(smoke_config(name), {},
                        ClusterSpec.build([("A100", 1), ("3090", 1)]),
                        primary_ids=[0], pool_ids=[1], device="cpu")
