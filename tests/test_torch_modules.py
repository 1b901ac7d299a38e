"""The port's model building blocks against the reference's, on identical
inputs made with numpy and weights bridged from the reference's
initialisers: rmsnorm, RoPE, the SwiGLU MLP, and the paged GQA attention
layer (with qk-norm, with qkv-bias) — its output and the pools after its
in-place K/V writes.  fp32 throughout, tolerance 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp

TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
            dtype="float32")


def t(a):
    """A torch copy of an array (the numpy inputs stay untouched by the
    port's in-place pool writes)."""
    return torch.from_numpy(np.array(a))


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    got = tcommon.rmsnorm(t(x), t(s), 1e-6).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 96, (2, 7)).astype(np.int32)
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta))
    got = tcommon.apply_rope(t(x), t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mlp_apply():
    cfg = JConfig(**BASE)
    p = jax.tree.map(np.asarray, jmlp.mlp_init(cfg, jax.random.PRNGKey(2)))
    x = np.random.default_rng(2).standard_normal((3, 4, 64)).astype(
        np.float32)
    want = np.asarray(jmlp.mlp_apply(cfg, jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x)))
    got = tmlp.mlp_apply(cfg, {k: t(v) for k, v in p.items()}, t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _attention_case(cfg, seed):
    """One mixed row batch against a 2-layer pool: a decode row, a
    prefill chunk crossing a page, and a padded row writing to the sink."""
    rng = np.random.default_rng(seed)
    L, Hkv, dh, page, C, maxp = cfg.n_layers, cfg.n_kv_heads, 16, 4, 4, 4
    slots = 3 * Hkv * maxp
    sink = slots
    kpool = rng.standard_normal((L, slots + 1, page, dh)).astype(np.float32)
    vpool = rng.standard_normal((L, slots + 1, page, dh)).astype(np.float32)
    tables = rng.permutation(slots).reshape(3, Hkv, maxp).astype(np.int32)
    rows = [(10, 1), (2, 4), (0, 0)]           # (start, n); n == 0: padded
    starts = np.asarray([s for s, _ in rows], np.int32)
    lengths = np.asarray([s + n if n else 0 for s, n in rows], np.int32)
    wslots = np.full((3, Hkv, C), sink, np.int32)
    woffs = np.zeros((3, C), np.int32)
    for b, (s, n) in enumerate(rows):
        for c in range(n):
            wslots[b, :, c] = tables[b, :, (s + c) // page]
            woffs[b, c] = (s + c) % page
    positions = starts[:, None] + np.arange(C, dtype=np.int32)[None]
    x = rng.standard_normal((3, C, cfg.d_model)).astype(np.float32)
    return (x, kpool, vpool, tables, lengths, starts, wslots, woffs,
            positions, sink)


@pytest.mark.parametrize("flavour", ["qk_norm", "qkv_bias"])
def test_gqa_prefill_paged(flavour):
    cfg = JConfig(**BASE, **{flavour: True}, rope_theta=1000000.0)
    p = jax.tree.map(np.asarray, jattn.gqa_init(cfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    # non-trivial norm scales and biases (the initialisers give 1 and 0)
    for k in ("q_norm", "k_norm", "bq", "bk", "bv"):
        if k in p:
            p[k] = (rng.standard_normal(p[k].shape) * 0.5 + 1.0).astype(
                np.float32)
    (x, kpool, vpool, tables, lengths, starts, wslots, woffs, positions,
     sink) = _attention_case(cfg, seed=5)
    idx = 1
    jout, jk, jv = jattn.gqa_prefill_paged(
        cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(kpool), jnp.asarray(vpool), idx, jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(starts), jnp.asarray(wslots),
        jnp.asarray(woffs), jnp.asarray(positions))
    tk, tv = t(kpool), t(vpool)
    tout, tk2, tv2 = tattn.gqa_prefill_paged(
        cfg, {k: t(v) for k, v in p.items()}, t(x), tk, tv, idx, t(tables),
        t(lengths), t(starts), t(wslots), t(woffs), t(positions))
    assert tk2 is tk and tv2 is tv              # updated in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    # pools after the writes, every slot but the sink (padded tokens all
    # land there, in an order neither framework specifies)
    keep = np.arange(kpool.shape[1]) != sink
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, keep],
                                   np.asarray(want)[:, keep], **TOL)
    # and the writes really happened: the decode row's page changed
    s0 = tables[0, 0, 10 // 4]
    assert not np.allclose(tk.numpy()[idx, s0], kpool[idx, s0])
