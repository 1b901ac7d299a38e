"""``sharded_fused_step`` of the port against the reference's: the same
bridged weights, the same per-device pool shards and the same step plan
(anchor-space tables, write slots, exchange lanes), for decode-only,
prefill-only and mixed row batches, and for steps whose rows have pages on
the remote shard (exchange lanes G > 0).  Logits within fp32 1e-4 (two
layers of fp32 products summed in another order than XLA's); every pool
slot but the sinks within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving.kvcache import PagedHeadCache
from repro_torch.weights import from_jax_params

SPEC = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
            dtype="float32", qk_norm=True)
JCFG, TCFG = JConfig(**SPEC), TConfig(**SPEC)
JPARAMS = JT.init_params(JCFG, jax.random.PRNGKey(0))
NPARAMS = jax.tree.map(np.asarray, JPARAMS)
TPARAMS = from_jax_params(TCFG, NPARAMS, device="cpu")
PAGE, SLOTS, STAGE = 4, 24, 16


def _bucket(n):
    b = 1
    while b < n:
        b *= 2
    return b


def make_step(kv, rows, seed):
    """The engine's fused-step operands for ``rows`` of (rid, start, n):
    the same construction as ``InferenceEngine._fused_step``."""
    rng = np.random.default_rng(seed)
    Hkv, sink = SPEC["n_kv_heads"], kv.sink
    B = len(rows)
    Bp = _bucket(B + 1)                          # at least one padded row
    Cp = _bucket(max(n for _, _, n in rows))
    Pp = _bucket(max(-(-(s + n) // PAGE) for _, s, n in rows))
    plan = kv.step_plan()
    toks = np.zeros((Bp, Cp), np.int32)
    starts = np.zeros((Bp,), np.int32)
    lengths = np.zeros((Bp,), np.int32)
    last_idx = np.zeros((Bp,), np.int32)
    tables = np.full((Bp, Hkv, Pp), sink, np.int32)
    wslots = np.full((Bp, Hkv, Cp), sink, np.int32)
    woffs = np.zeros((Bp, Cp), np.int32)
    ws, wo = plan.mixed_scatter_indices(rows, Cp)
    wslots[:B], woffs[:B] = ws, wo
    for i, (rid, s0, n) in enumerate(rows):
        starts[i], lengths[i], last_idx[i] = s0, s0 + n, n - 1
        tables[i] = plan.block_table_matrix(rid, Pp, n_tokens=s0 + n)
        toks[i, :n] = rng.integers(0, SPEC["vocab_size"], n)
    G = plan.gather_count
    exch = plan.exchange_arrays(0 if G == 0 else _bucket(G))
    return exch + (tables, lengths, starts, wslots, woffs, toks, last_idx)


def make_cache(placement):
    """Chains for three requests; ``placement[rid]`` lists each kv group's
    device (1 = the remote shard).  Every chain holds 14 tokens."""
    kv = PagedHeadCache(TCFG, {0: SLOTS, 1: SLOTS}, page_size=PAGE,
                        anchor=0, stage_slots=STAGE, device="cpu")
    for rid, devs in placement.items():
        for g, dev in enumerate(devs):
            assert kv.ensure_capacity(rid, g, dev, 14)
    return kv


ANCHOR_ONLY = {0: [0, 0], 1: [0, 0], 2: [0, 0]}
SPLIT = {0: [0, 1], 1: [1, 1], 2: [0, 0]}
CASES = {
    "decode_only": (ANCHOR_ONLY, [(0, 9, 1), (1, 12, 1), (2, 3, 1)]),
    "prefill_only": (ANCHOR_ONLY, [(0, 0, 8), (1, 4, 5)]),
    "mixed": (ANCHOR_ONLY, [(0, 13, 1), (1, 0, 8), (2, 6, 3)]),
    "mixed_remote_pages": (SPLIT, [(0, 13, 1), (1, 2, 8), (2, 10, 1)]),
    "decode_remote_pages": (SPLIT, [(0, 7, 1), (1, 11, 1)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_fused_step_matches_reference(name):
    placement, rows = CASES[name]
    kv = make_cache(placement)
    seed = sorted(CASES).index(name)
    arrays = make_step(kv, rows, seed)
    G = arrays[0].shape[0]
    assert (G > 0) == ("remote" in name)
    rng = np.random.default_rng(100 + seed)
    shapes = {d: tuple(p.shape) for d, p in kv.kpools.items()}
    kp = {d: rng.standard_normal(s).astype(np.float32)
          for d, s in shapes.items()}
    vp = {d: rng.standard_normal(s).astype(np.float32)
          for d, s in shapes.items()}
    anchor, asink = kv.anchor, kv.sink

    jstep = jax.jit(lambda p, k, v, *a: JT.sharded_fused_step(
        JCFG, p, k, v, anchor, asink, *a))
    jlog, jk, jv = jstep(JPARAMS, {d: jnp.asarray(a) for d, a in kp.items()},
                         {d: jnp.asarray(a) for d, a in vp.items()},
                         *map(jnp.asarray, arrays))
    tk = {d: torch.from_numpy(a.copy()) for d, a in kp.items()}
    tv = {d: torch.from_numpy(a.copy()) for d, a in vp.items()}
    tlog, tk2, tv2 = TT.sharded_fused_step(
        TCFG, TPARAMS, tk, tv, anchor, asink,
        *map(torch.from_numpy, arrays))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)
    for d in kp:
        keep = np.arange(shapes[d][1]) != kv.sink_of(d)
        for got, want, before in ((tk2[d], jk[d], kp[d]),
                                  (tv2[d], jv[d], vp[d])):
            np.testing.assert_allclose(got.numpy()[:, keep],
                                       np.asarray(want)[:, keep],
                                       rtol=1e-5, atol=1e-5)
    # remote rows really wrote back through the staging region
    if G:
        assert not np.allclose(tk2[1].numpy(), kp[1])


def test_bridge_keeps_layout_and_values():
    g = NPARAMS["groups"][0]
    tg = TPARAMS["groups"][0]
    assert tuple(tg["attn"]["wq"].shape) == g["attn"]["wq"].shape
    assert tuple(tg["mlp"]["wi"].shape) == (2, 64, 128)    # (L, in, out)
    np.testing.assert_array_equal(tg["attn"]["wk"].numpy(), g["attn"]["wk"])
    np.testing.assert_array_equal(TPARAMS["lm_head"].numpy(),
                                  NPARAMS["lm_head"])


def test_bridge_bf16_and_tied_embeddings():
    spec = dict(SPEC, dtype="bfloat16", tie_embeddings=True)
    jp = jax.tree.map(np.asarray, JT.init_params(JConfig(**spec),
                                                 jax.random.PRNGKey(1)))
    tp = from_jax_params(TConfig(**spec), jp, device="cpu")
    assert "lm_head" not in tp
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(), jp["embed"].astype(np.float32))
    head = TT._lm_head(TConfig(**spec), tp)
    assert tuple(head.shape) == (64, 128)
