"""The dense oracle modes of the port against the reference, on identical
numpy inputs and weights bridged from the reference's initialisers:

  * the dense attention pieces (``attention_core``, ``decode_attention``,
    ``gqa_full`` — whose attention is the flash-attention kernel's plain
    version on the CPU — ``gqa_decode`` and ``gqa_decode_carry``);
  * the dense model: ``prefill`` (last-token logits within 2e-4, every
    cache leaf within 1e-6 at layer 0 and 1e-5 deeper, where the two
    frameworks' fp32 sums of layer 0's output already differ by ~1e-6) and
    ``decode_step`` under "carry" and "stacked" over several steps;
  * the kv-cache methods of the dense path (``store_prompt_request``,
    ``append_token``, ``store_token``, ``gather_dense``);
  * the engine under every mode combination with a dense mode, {paged,
    dense}^2 x {fused, split} less paged/paged, against the reference's
    engine — tokens, counters, per-device occupancy, distinct call shapes
    and the schedule flags, with migration, preemption and memory
    exhaustion interleaved — and all eight combinations against the
    port's own plain decode (``prefill`` then ``decode_step``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import (JCFG, JPARAMS, SPEC, TCFG, TPARAMS,
                               assert_same, make_pair, submit_both)
from test_torch_kvcache import assert_same_state
from test_torch_split import make_engine
from test_torch_kvcache import make_pair as make_cache_pair
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.serving import Request as TRequest

LOGITS = dict(rtol=2e-4, atol=2e-4)
CACHE0 = dict(rtol=1e-6, atol=1e-6)
CACHE = dict(rtol=1e-5, atol=1e-5)
MODULE = dict(rtol=1e-5, atol=1e-5)
MODES = [(p, d, s) for p in ("paged", "dense") for d in ("paged", "dense")
         for s in ("fused", "split")]
# the paged/paged pair runs the same scenarios in test_torch_engine.py and
# test_torch_split.py
DENSE_MODES = [m for m in MODES if "dense" in m]


def t(a):
    """A torch copy of an array (in-place updates leave the input be)."""
    return torch.from_numpy(np.array(a))


def layer_params(gi=0, li=0):
    """One layer's attention weights from the bridged parameters, as JAX
    and torch dicts."""
    jp = jax.tree.map(lambda a: a[li], JPARAMS["groups"][gi]["attn"])
    tp = {k: v[li] for k, v in TPARAMS["groups"][gi]["attn"].items()}
    return jp, tp


def test_attention_core_and_decode_attention():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    bias = np.where(rng.random((2, 1, 1, 5, 9)) < 0.3, jcommon.NEG_INF,
                    0.0).astype(np.float32)
    bias[..., 0] = 0.0
    want = jcommon.attention_core(*map(jnp.asarray, (q, k, v, bias)), 0.25)
    got = tcommon.attention_core(t(q), t(k), t(v), t(bias), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE)
    kv_len = np.array([9, 4], np.int32)
    for window in (0, 3):
        want = jcommon.decode_attention(
            jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(kv_len), window=window)
        got = tcommon.decode_attention(t(q[:, :1]), t(k), t(v), t(kv_len),
                                       window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE)


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_full(window):
    jp, tp = layer_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, SPEC["d_model"])).astype(np.float32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    jo, jc = jattn.gqa_full(JCFG, jp, jnp.asarray(x), jnp.asarray(pos),
                            window)
    to, tc = tattn.gqa_full(TCFG, tp, t(x), t(pos), window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODULE)
    for key in ("k", "v"):
        assert tc[key].dtype == torch.float32
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **MODULE)


def test_gqa_decode_and_decode_carry():
    jp, tp = layer_params()
    rng = np.random.default_rng(2)
    B, S = 3, 12
    x = rng.standard_normal((B, 1, SPEC["d_model"])).astype(np.float32)
    kc = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)
    jo, jc = jattn.gqa_decode(JCFG, jp, jnp.asarray(x),
                              {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                              jnp.asarray(pos))
    tk, tv = t(kc), t(vc)
    to, tc = tattn.gqa_decode(TCFG, tp, t(x), {"k": tk, "v": tv}, t(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODULE)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **MODULE)
    # "stacked" leaves its input cache as it was
    np.testing.assert_array_equal(tk.numpy(), kc)
    kf = np.stack([kc, kc[::-1]])
    vf = np.stack([vc, vc[::-1]])
    jo, jk, jv = jattn.gqa_decode_carry(JCFG, jp, jnp.asarray(x),
                                        jnp.asarray(kf), jnp.asarray(vf), 1,
                                        jnp.asarray(pos))
    tkf, tvf = t(kf), t(vf)
    to, tk2, tv2 = tattn.gqa_decode_carry(TCFG, tp, t(x), tkf, tvf, 1,
                                          t(pos))
    assert tk2 is tkf and tv2 is tvf         # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODULE)
    np.testing.assert_allclose(tkf.numpy(), np.asarray(jk), **MODULE)
    np.testing.assert_allclose(tvf.numpy(), np.asarray(jv), **MODULE)


def assert_caches(tc, jc):
    """Every cache leaf: layer 0 within 1e-6, all layers within 1e-5."""
    for tg, jg in zip(tc["groups"], jc["groups"]):
        assert set(tg) == set(jg)
        for key in tg:
            got, want = tg[key].numpy(), np.asarray(jg[key])
            assert got.shape == want.shape
            np.testing.assert_allclose(got[0], want[0], **CACHE0)
            np.testing.assert_allclose(got, want, **CACHE)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_prefill_matches_reference():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, SPEC["vocab_size"], (2, 21)).astype(np.int32)
    lengths = np.array([21, 14], np.int32)
    jl, jc = JT.prefill(JCFG, JPARAMS, {"tokens": jnp.asarray(toks)},
                        max_seq=40, lengths=jnp.asarray(lengths))
    tl, tc = TT.prefill(TCFG, TPARAMS, {"tokens": t(toks)}, max_seq=40,
                        lengths=t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert_caches(tc, jc)
    assert tc["groups"][0]["k"].shape[2] == 40
    assert not tc["groups"][0]["k"][:, :, 21:].any()
    with pytest.raises(ValueError, match="max_seq"):
        TT.prefill(TCFG, TPARAMS, {"tokens": t(toks)}, max_seq=16)


@pytest.mark.parametrize("impl", ["carry", "stacked"])
def test_decode_step_matches_reference(impl):
    jcfg = dataclasses.replace(JCFG, decode_impl=impl)
    tcfg = dataclasses.replace(TCFG, decode_impl=impl)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, SPEC["vocab_size"], (2, 9)).astype(np.int32)
    _, jc = JT.prefill(jcfg, JPARAMS, {"tokens": jnp.asarray(toks)},
                       max_seq=16)
    _, tc = TT.prefill(tcfg, TPARAMS, {"tokens": t(toks)}, max_seq=16)
    for _ in range(4):
        new = rng.integers(0, SPEC["vocab_size"], (2, 1)).astype(np.int32)
        before = tc["groups"][0]["k"]
        jl, jc = JT.decode_step(jcfg, JPARAMS, jc, jnp.asarray(new))
        tl, tc = TT.decode_step(tcfg, TPARAMS, tc, t(new))
        assert (tc["groups"][0]["k"] is before) == (impl == "carry")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        assert_caches(tc, jc)


def test_dense_kv_cache_methods():
    """store_prompt_request (one chain split over both pool shards),
    append_token with and without K/V, store_token, then gather_dense:
    same pools, lengths, tables and dense views in both packages."""
    j, tcache = make_cache_pair()
    rng = np.random.default_rng(5)
    L, dh = SPEC["n_layers"], SPEC["head_dim"]
    for kv in (j, tcache):
        kv.ensure_capacity(0, 0, 0, 6)
        kv.ensure_capacity(0, 0, 1, 11)           # the chain's tail remote
        kv.ensure_capacity(0, 1, 1, 11)
        kv.ensure_capacity(1, 0, 0, 3)
        kv.ensure_capacity(1, 1, 0, 3)
    k = rng.standard_normal((L, 11, 2, dh)).astype(np.float32)
    v = rng.standard_normal((L, 11, 2, dh)).astype(np.float32)
    j.store_prompt_request(0, jnp.asarray(k), jnp.asarray(v))
    tcache.store_prompt_request(0, t(k), t(v))
    assert_same_state(j, tcache, pools=True)
    for rid, g, dev in [(0, 0, 1), (0, 1, 1), (1, 0, 0), (1, 1, 0)]:
        kt = rng.standard_normal((L, dh)).astype(np.float32)
        vt = rng.standard_normal((L, dh)).astype(np.float32)
        assert j.append_token(rid, g, dev, (kt, vt)) \
            == tcache.append_token(rid, g, dev, (kt, vt))
        assert j.append_token(rid, g, dev) == tcache.append_token(rid, g,
                                                                   dev)
        j.store_token(rid, g, j.lengths[(rid, g)] - 1, vt, kt)
        tcache.store_token(rid, g, tcache.lengths[(rid, g)] - 1, vt, kt)
    assert_same_state(j, tcache, pools=True)
    for rid, max_len in [(0, 16), (0, 9), (1, 8)]:
        for a, b in zip(j.gather_dense(rid, max_len),
                        tcache.gather_dense(rid, max_len)):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(b, a)


def test_gather_dense_widens_bf16_pools():
    """numpy has no bf16: a bf16 pool is widened on the device, the host
    arrays hold exactly the stored values."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.kvcache import PagedHeadCache
    cfg = ModelConfig(**dict(SPEC, dtype="bfloat16"))
    kv = PagedHeadCache(cfg, {0: 8}, page_size=4, device="cpu")
    for g in range(2):
        kv.ensure_capacity(0, g, 0, 6)
    k = torch.randn(2, 6, 2, 16).to(torch.bfloat16)
    kv.store_prompt_request(0, k, -k)
    K, V = kv.gather_dense(0, 8)
    assert K.dtype == np.float32 and K.shape == (2, 8, 2, 16)
    np.testing.assert_array_equal(K[:, :6], k.float().numpy())
    np.testing.assert_array_equal(V[:, :6], -k.float().numpy())
    assert not K[:, 6:].any()


def assert_same_dense(j, t):
    assert_same(j, t)
    assert t.snapshot()["jit/recompiles"] == j.snapshot()["jit/recompiles"]
    assert (t.use_paged, t.use_paged_prefill, t.use_fused) \
        == (j.use_paged, j.use_paged_prefill, j.use_fused)


@pytest.mark.parametrize("prefill_mode, decode_mode, step_mode", DENSE_MODES)
def test_mode_matrix_migration_and_preemption(prefill_mode, decode_mode,
                                              step_mode):
    j, t = make_pair(prefill_mode=prefill_mode, decode_mode=decode_mode,
                     step_mode=step_mode)
    submit_both(j, t, 3, seed=3, lo=6, hi=14, max_new=5)
    for _ in range(3):
        j.step()
        t.step()
    assert_same_dense(j, t)
    movers = [r.rid for r in j.running][:2]
    assert movers
    for eng in (j, t):
        for rid in movers:
            eng._apply_migration(rid, {1: SPEC["n_heads"]})
    assert_same_dense(j, t)
    victims = [r.rid for r in j.running if r.output][:1]
    assert victims
    for eng in (j, t):
        for rid in victims:
            eng._preempt(next(r for r in eng.running if r.rid == rid))
    assert_same_dense(j, t)
    assert j.run_until_drained(200) and t.run_until_drained(200)
    assert len(t.finished) == 3
    t.kv.check_invariants()
    assert_same_dense(j, t)


def exhaustion_pair(prefill_mode, decode_mode, slots, seed):
    """Both engines with ~``slots`` pages per device and 5 requests of
    14-29 prompt tokens: too small for the load."""
    cap = slots * 2 * 8 * 16 * 4 * 2 * 2 / 1e9
    j, t = make_pair(prefill_mode=prefill_mode, decode_mode=decode_mode,
                     cache_gb_per_device={0: cap, 1: cap})
    submit_both(j, t, 5, seed=seed, lo=14, hi=30, max_new=5)
    return j, t


@pytest.mark.parametrize("prefill_mode, decode_mode, slots, seed",
                         [("dense", "paged", 14, 12),
                          ("paged", "dense", 14, 16),
                          ("dense", "dense", 14, 15)])
def test_dense_modes_memory_exhaustion(prefill_mode, decode_mode, slots,
                                       seed):
    """Caches too small for the load: §5.3 exhaustion handling (in the
    dense decode's append_token or the paged reservation) migrates, and
    evicts, mid-run on both engines alike.  (Under dense decode the
    eviction of a row of the batch being stored is the reference's fault
    pinned below, so those cases load the cache to migration only.)"""
    j, t = exhaustion_pair(prefill_mode, decode_mode, slots, seed)
    for _ in range(200):
        if not (j.queue or j.running or j.prefilling):
            break
        j.step()
        t.step()
        assert_same_dense(j, t)
    assert len(t.finished) == 5
    assert t.metrics["redispatches"] > 0
    if decode_mode == "paged":
        assert t.metrics["evictions"] > 0
    t.kv.check_invariants()


def test_dense_decode_survives_evicting_its_own_batch():
    """ROADMAP Queue C: when the dense decode's exhaustion handling
    preempts a request of the batch it is storing, the reference stores
    that request's K/V into fresh chains, appends its token anyway and
    raises in ``_finish`` when the token ends it.  The port skips the
    preempted rows (their replay recomputes the token exactly): it
    drains, keeps its invariants and still emits the plain decode."""
    j, t = exhaustion_pair("paged", "dense", 14, 11)
    with pytest.raises(ValueError, match="not in list"):
        j.run_until_drained(200)
    assert t.run_until_drained(200)
    assert t.metrics["evictions"] > 0
    t.kv.check_invariants()
    assert not t.kv.tables and all(p.used == 0
                                   for p in t.kv.partitions.values())
    rng = np.random.default_rng(11)
    for i in range(5):
        prompt = [int(x) for x in rng.integers(0, SPEC["vocab_size"],
                                               rng.integers(14, 30))]
        r = next(r for r in t.finished if r.rid == i)
        assert r.output == plain_decode(prompt, 5)


def plain_decode(prompt, n, max_seq=96):
    """The port's own plain decode: ``prefill`` then ``decode_step``."""
    logits, cache = TT.prefill(TCFG, TPARAMS,
                               {"tokens": torch.tensor([prompt])},
                               max_seq=max_seq)
    out = [int(logits[0].argmax())]
    for _ in range(n - 1):
        logits, cache = TT.decode_step(TCFG, TPARAMS, cache,
                                       torch.tensor([[out[-1]]]))
        out.append(int(logits[0].argmax()))
    return out


def test_every_mode_emits_the_plain_decode():
    """Prompt lengths on every page/chunk boundary case (1, page - 1,
    page, page + 1, multi-page): each mode combination's engine emits the
    port's plain decode token for token."""
    page = 8
    rng = np.random.default_rng(0)
    prompts = [[int(x) for x in rng.integers(0, SPEC["vocab_size"], n)]
               for n in (1, page - 1, page, page + 1, 3 * page + 5)]
    want = {i: plain_decode(p, 5) for i, p in enumerate(prompts)}
    for prefill_mode, decode_mode, step_mode in MODES:
        eng = make_engine(prefill_mode=prefill_mode,
                          decode_mode=decode_mode, step_mode=step_mode)
        for i, p in enumerate(prompts):
            eng.submit(TRequest(rid=i, prompt=list(p), max_new_tokens=5))
        assert eng.run_until_drained(400)
        eng.kv.check_invariants()
        assert {r.rid: r.output for r in eng.finished} == want, \
            (prefill_mode, decode_mode, step_mode)
