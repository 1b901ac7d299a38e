"""The split schedule's model path against the reference's, on identical
inputs made with numpy: the paged decode-attention kernel's plain version
(the port's wrapper on CPU tensors) against the Pallas kernel in interpret
mode and its pure-jnp oracle; then ``gqa_decode_paged``,
``paged_decode_step``, ``sharded_decode_step`` (with gather and writeback
lanes) and ``sharded_prefill_chunk``.  Kernel tolerances are the
reference's own (fp32 2e-5, bf16 2e-2); modules and steps are fp32 with
logits within 2e-5 and every pool slot but the sinks within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention import (paged_attention as
                                           jax_paged_attention,
                                           paged_attention_ref as
                                           jax_paged_attention_ref)
from repro.models import attention as jattn
from repro.models import transformer as JT
from test_torch_transformer import (ANCHOR_ONLY, JCFG, JPARAMS, PAGE, SPEC,
                                    SPLIT, TCFG, TPARAMS, _bucket,
                                    make_cache, make_step)
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as TT

# fp32: 2e-5 (two fp32 softmax pipelines, summed in another order);
# bf16: 2e-2 (the kernel rounds P to bf16 before PV, the oracle does not)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def t(a):
    """A torch copy of an array (numpy inputs stay untouched by the port's
    in-place pool writes)."""
    return torch.from_numpy(np.array(a))


def make_decode_case(seed, lengths, Hkv, r, dh, page, maxp,
                     bad_tables=False):
    """Decode-kernel inputs as numpy: a permuted slot table and per-row
    lengths (0 makes a padded row).  ``bad_tables`` puts out-of-range ids
    (negative and past the pool) in the entries past each row's length,
    which the wrapper must clip."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    slots = B * Hkv * maxp + 3
    tables = rng.permutation(slots)[:B * Hkv * maxp].reshape(B, Hkv, maxp)
    lengths = np.asarray(lengths, np.int32)
    if bad_tables:
        for b in range(B):
            need = -(-int(lengths[b]) // page)
            tables[b, :, need:] = rng.choice([-7, slots + 5, 10 ** 6],
                                             size=tables[b, :, need:].shape)
    return dict(q=rng.standard_normal((B, Hkv, r, dh)).astype(np.float32),
                k=rng.standard_normal((slots, page, dh)).astype(np.float32),
                v=rng.standard_normal((slots, page, dh)).astype(np.float32),
                tables=tables.astype(np.int32), lengths=lengths)


DECODE_CASES = {
    # MHA (r = 1): ragged lengths with a padded row and an exact page
    # boundary (16 = 2 pages of 8)
    "r1_ragged": dict(lengths=[5, 0, 16, 31], Hkv=2, r=1, dh=16, page=8,
                      maxp=4),
    # GQA r = 2, dh 64, every page of the table in use by one row
    "r2_dh64": dict(lengths=[48, 17, 1], Hkv=2, r=2, dh=64, page=16,
                    maxp=3),
}


def _run_both(case, dtype):
    jdt, tdt = JDT[dtype], TDT[dtype]
    jargs = (jnp.asarray(case["q"], jdt), jnp.asarray(case["k"], jdt),
             jnp.asarray(case["v"], jdt), jnp.asarray(case["tables"]),
             jnp.asarray(case["lengths"]))
    targs = (t(case["q"]).to(tdt), t(case["k"]).to(tdt),
             t(case["v"]).to(tdt), t(case["tables"]), t(case["lengths"]))
    return jargs, ops.paged_attention(*targs).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_kernel_plain_matches_pallas_and_oracle(name, dtype):
    case = make_decode_case(sorted(DECODE_CASES).index(name),
                            **DECODE_CASES[name])
    jargs, got = _run_both(case, dtype)
    kern = np.asarray(jax_paged_attention(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    ref = np.asarray(jax_paged_attention_ref(*jargs), np.float32)
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    assert got.shape == case["q"].shape
    for b in np.flatnonzero(case["lengths"] == 0):
        assert np.all(got[b] == 0.0)       # lengths == 0: l == 0 -> 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_clips_out_of_range_tables(dtype):
    case = make_decode_case(7, bad_tables=True, **DECODE_CASES["r1_ragged"])
    assert case["tables"].min() < 0
    assert case["tables"].max() >= case["k"].shape[0]
    jargs, got = _run_both(case, dtype)
    kern = np.asarray(jax_paged_attention(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL[dtype])


def _unmasked_plain(q, k, v, tables, lengths):
    """The plain decode version as it was before it cleared V past each
    length (the reference oracle's form: weight 0 times whatever V holds)."""
    B, Hkv, r, dh = q.shape
    S = tables.shape[-1] * k.shape[1]
    K = k[tables.long()].reshape(B, Hkv, S, dh).float()
    V = v[tables.long()].reshape(B, Hkv, S, dh).float()
    s = torch.einsum("bhrd,bhkd->bhrk", q.float(), K) / dh ** 0.5
    valid = torch.arange(S)[None, :] < lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bhrk,bhkd->bhrd", w, V).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_plain_keeps_pool_contents_past_the_lengths_out(name, dtype):
    """NaN in every pool row past each row's length (its last page's tail,
    its later pages, a padded row's pages) and in every slot no table
    names: the plain version (the wrapper on CPU tensors) gives a finite
    output, equal to its output on the finite pools, which equals the
    unmasked form's there."""
    case = make_decode_case(3, **DECODE_CASES[name])
    q, k, v, tables, lengths = (t(case[n]) for n in (
        "q", "k", "v", "tables", "lengths"))
    q, k, v = (x.to(TDT[dtype]) for x in (q, k, v))
    finite = ops.paged_attention(q, k, v, tables, lengths)
    assert torch.equal(finite, _unmasked_plain(q, k, v, tables, lengths))
    page = k.shape[1]
    pos = torch.arange(tables.shape[-1] * page)
    slot = tables.long()[..., pos // page]                   # (B, Hkv, S)
    row = (pos % page).expand_as(slot)
    past = (pos >= lengths.long()[:, None, None]).expand_as(slot)
    named = torch.zeros(k.shape[0], dtype=torch.bool)
    named[tables.long().flatten()] = True
    kp, vp = k.clone(), v.clone()
    for pool in (kp, vp):
        pool[slot[past], row[past]] = float("nan")
        pool[~named] = float("nan")
    assert torch.isnan(vp).any() and past.any()
    got = ops.paged_attention(q, kp, vp, tables, lengths)
    assert torch.isfinite(got).all()
    assert torch.equal(got, finite)
    assert not torch.isfinite(_unmasked_plain(q, kp, vp, tables,
                                              lengths)).all()


def test_decode_kernel_cpu_tensors_never_touch_the_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel loader touched for CPU tensors")
    monkeypatch.setattr(build, "load", boom)
    before = dict(ops.LAUNCHES)
    _run_both(make_decode_case(1, **DECODE_CASES["r2_dh64"]), "float32")
    assert ops.LAUNCHES == before


def test_decode_wrapper_rejects_bad_ranks():
    pool = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError, match="bad ranks"):
        ops.paged_attention(torch.zeros((1, 1, 1, 2, 16)), pool, pool,
                            torch.zeros((1, 1, 2), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32))


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("flavour", ["qk_norm", "qkv_bias"])
def test_gqa_decode_paged(flavour):
    """One decode layer against a 2-layer pool: rows at a page's first
    and last offset, and a padded row writing to the sink."""
    from repro.models.config import ModelConfig as JConfig
    cfg = JConfig(**dict(SPEC, **{flavour: True}), rope_theta=1000000.0)
    p = jax.tree.map(np.asarray, jattn.gqa_init(cfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    for k in ("q_norm", "k_norm", "bq", "bk", "bv"):
        if k in p:
            p[k] = (rng.standard_normal(p[k].shape) * 0.5 + 1.0).astype(
                np.float32)
    L, Hkv, dh, page, maxp = 2, cfg.n_kv_heads, cfg.head_dim, 4, 4
    slots = 3 * Hkv * maxp
    sink = slots
    kpool = rng.standard_normal((L, slots + 1, page, dh)).astype(np.float32)
    vpool = rng.standard_normal((L, slots + 1, page, dh)).astype(np.float32)
    tables = rng.permutation(slots).reshape(3, Hkv, maxp).astype(np.int32)
    pos = np.asarray([8, 11, 0], np.int32)     # row 2 is padded
    lengths = np.asarray([9, 12, 0], np.int32)
    wslot = np.full((3, Hkv), sink, np.int32)
    woff = np.zeros((3,), np.int32)
    for b in range(2):
        wslot[b] = tables[b, :, pos[b] // page]
        woff[b] = pos[b] % page
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    idx = 1
    jout, jk, jv = jattn.gqa_decode_paged(
        cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(kpool), jnp.asarray(vpool), idx, jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(wslot), jnp.asarray(woff),
        jnp.asarray(pos))
    tk, tv = t(kpool), t(vpool)
    tout, tk2, tv2 = tattn.gqa_decode_paged(
        cfg, {k: t(v) for k, v in p.items()}, t(x), tk, tv, idx, t(tables),
        t(lengths), t(wslot), t(woff), t(pos))
    assert tk2 is tk and tv2 is tv              # updated in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    keep = np.arange(kpool.shape[1]) != sink
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, keep],
                                   np.asarray(want)[:, keep],
                                   rtol=1e-5, atol=1e-5)
    assert not np.allclose(tk.numpy()[idx, wslot[0, 0]],
                           kpool[idx, wslot[0, 0]])


# ------------------------------------------------------------- steps
def make_decode_step(kv, rows, seed):
    """The engine's decode-call operands for ``rows`` of (rid, ctx): the
    same construction as ``InferenceEngine._decode_batch``, with at least
    one padded row."""
    rng = np.random.default_rng(seed)
    Hkv, sink = SPEC["n_kv_heads"], kv.sink
    B = len(rows)
    Bp = _bucket(B + 1)
    Pp = _bucket(max(-(-ctx // PAGE) for _, ctx in rows))
    plan = kv.step_plan()
    tables = np.full((Bp, Hkv, Pp), sink, np.int32)
    lengths = np.zeros((Bp,), np.int32)
    wslot = np.full((Bp, Hkv), sink, np.int32)
    woff = np.zeros((Bp,), np.int32)
    pos = np.zeros((Bp,), np.int32)
    toks = np.zeros((Bp, 1), np.int32)
    for i, (rid, ctx) in enumerate(rows):
        tables[i] = plan.block_table_matrix(rid, Pp, n_tokens=ctx)
        slots, offs = plan.scatter_indices(rid, ctx - 1, 1)
        wslot[i], woff[i] = slots[:, 0], offs[0]
        lengths[i], pos[i] = ctx, ctx - 1
        toks[i, 0] = rng.integers(0, SPEC["vocab_size"])
    G = plan.gather_count
    exch = plan.exchange_arrays(0 if G == 0 else _bucket(G))
    return exch + (tables, lengths, wslot, woff, toks, pos)


STEP_CASES = {
    "decode": (ANCHOR_ONLY, "decode", [(0, 9), (1, 13), (2, 4)]),
    "decode_remote_pages": (SPLIT, "decode", [(0, 14), (1, 8), (2, 12)]),
    "prefill": (ANCHOR_ONLY, "prefill", [(0, 0, 8), (1, 4, 5)]),
    "prefill_remote_pages": (SPLIT, "prefill", [(0, 6, 8), (1, 0, 3)]),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_split_steps_match_reference(name):
    placement, kind, rows = STEP_CASES[name]
    kv = make_cache(placement)
    seed = sorted(STEP_CASES).index(name)
    if kind == "decode":
        arrays = make_decode_step(kv, rows, seed)
        jfn, tfn = JT.sharded_decode_step, TT.sharded_decode_step
    else:
        arrays = make_step(kv, rows, seed)
        jfn, tfn = JT.sharded_prefill_chunk, TT.sharded_prefill_chunk
    G = arrays[0].shape[0]
    assert (G > 0) == ("remote" in name)
    rng = np.random.default_rng(100 + seed)
    shapes = {d: tuple(p.shape) for d, p in kv.kpools.items()}
    kp = {d: rng.standard_normal(s).astype(np.float32)
          for d, s in shapes.items()}
    vp = {d: rng.standard_normal(s).astype(np.float32)
          for d, s in shapes.items()}
    anchor, asink = kv.anchor, kv.sink
    jstep = jax.jit(lambda p, k, v, *a: jfn(JCFG, p, k, v, anchor, asink,
                                            *a))
    jlog, jk, jv = jstep(JPARAMS, {d: jnp.asarray(a) for d, a in kp.items()},
                         {d: jnp.asarray(a) for d, a in vp.items()},
                         *map(jnp.asarray, arrays))
    tk = {d: t(a) for d, a in kp.items()}
    tv = {d: t(a) for d, a in vp.items()}
    tlog, tk2, tv2 = tfn(TCFG, TPARAMS, tk, tv, anchor, asink,
                         *map(torch.from_numpy, arrays))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=2e-5, atol=2e-5)
    for d in kp:
        keep = np.arange(shapes[d][1]) != kv.sink_of(d)
        for got, want in ((tk2[d], jk[d]), (tv2[d], jv[d])):
            np.testing.assert_allclose(got.numpy()[:, keep],
                                       np.asarray(want)[:, keep],
                                       rtol=1e-5, atol=1e-5)
    if G:      # remote rows really wrote back through the staging region
        assert not np.allclose(tk2[1].numpy(), kp[1])


def test_paged_decode_step_single_pool():
    """``paged_decode_step`` on one pool, as the sharded step runs it on
    the anchor: the same logits and pools as the reference's."""
    kv = make_cache(ANCHOR_ONLY)
    arrays = make_decode_step(kv, [(0, 14), (2, 7)], seed=9)[6:]
    rng = np.random.default_rng(9)
    shape = tuple(kv.kpools[0].shape)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    jlog, jk, jv = jax.jit(lambda p, k, v, *a: JT.paged_decode_step(
        JCFG, p, k, v, *a))(JPARAMS, jnp.asarray(kp), jnp.asarray(vp),
                            *map(jnp.asarray, arrays))
    tlog, tk, tv = TT.paged_decode_step(TCFG, TPARAMS, t(kp), t(vp),
                                        *map(torch.from_numpy, arrays))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=2e-5, atol=2e-5)
    keep = np.arange(shape[1]) != kv.sink
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, keep],
                                   np.asarray(want)[:, keep],
                                   rtol=1e-5, atol=1e-5)
