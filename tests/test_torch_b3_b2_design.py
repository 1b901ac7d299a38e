"""The tensor-core designs of the dense flash-attention kernel (B3) and the
paged decode kernel (B2), held on the CPU.

``emulate_flash`` repeats B3's fp32 decomposition in plain PyTorch: GQA
rows folded as position * r + head-in-group, query tiles of the kernel's
height and key tiles of its width, each tile's key range from its first
and last position (causal, window and kv_len skipping of whole tiles), an
online softmax in fp32 (log2 units).  B3's bf16 cases run the bf16
kernel's own design, per-head tiles on wgmma
(``_b3_fwd_emulation.emulate_forward``; ``test_torch_b3_fwd_design.py``).
``emulate_decode`` repeats B2's: the r query rows of a (row, kv head) as
one tile, its keys cut into the spans of the wrapper's split plan (the
C = 1 plan of ``ops.split_plan``) and read through the table with every
entry clamped, dead spans skipped, fp32 partials merged.  Both are held
against the port's plain versions and the reference's Pallas kernels
(interpret mode) on inputs made with numpy from a seed.  Tolerances: fp32
2e-5 (the same function summed in another order), bf16 2e-2 (P rounded to
bf16 before PV, which the plain versions do not do)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _b3_fwd_emulation import emulate_forward
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_attention as jax_decode
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NEG_INF = -1e30
LOG2E = 1.4426950408889634
# the shared tile's sizes (csrc/attention_tile.cuh): B3's folded query rows
# per block and fp32 key tile, and the key tile of a one-warp split tile
# (B2)
QUERY_TILE = 64
KEY_TILE = 32
SPLIT_KEY_TILE = 32


def attend_span(qf, key_rows, lo, hi, k_lo, k_hi, bn, dtype):
    """One tile of folded query rows ``qf`` (fp32, already scaled) over the
    key tiles of bn keys from k_lo; keys >= k_hi are zero-filled.  Row i
    sees keys in [lo[i], hi[i]).  ``key_rows(keys)`` gives the keys' (K, V)
    rows.  Returns the unnormalised fp32 (m, l, acc)."""
    n, dh = qf.shape
    m = torch.full((n,), NEG_INF)
    l = torch.zeros(n)
    acc = torch.zeros(n, dh)
    for k0 in range(k_lo, k_hi, bn):
        keys = torch.arange(k0, k0 + bn)
        live = keys < k_hi
        K, V = key_rows(torch.where(live, keys, k_lo))
        K = torch.where(live[:, None], K.float(), 0.)
        V = torch.where(live[:, None], V.float(), 0.)
        ok = (keys[None, :] >= lo[:, None]) & (keys[None, :] < hi[:, None])
        sc = torch.where(ok, qf @ K.T, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp2(sc - m_new[:, None]) * ok
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = alpha[:, None] * acc + p.to(dtype).float() @ V
        m = m_new
    return m, l, acc


def finish(parts, merged=False):
    """The output rows of one tile from its live spans' partials: an
    unsplit tile divides by its l, a split one merges its live spans
    (weights 2^(m_s - max m)); 0 where l == 0 or no span is live."""
    if not merged:
        m, l, acc = parts[0]
        return acc / torch.where(l > 0, l, 1.)[:, None]
    ms = torch.stack([pm for pm, _, _ in parts])
    w = torch.exp2(ms - ms.amax(0))
    lsum = (w * torch.stack([pl for _, pl, _ in parts])).sum(0)
    osum = (w[..., None] * torch.stack([pa for _, _, pa in parts])).sum(0)
    return torch.where(lsum[:, None] > 0,
                       osum / lsum.clamp(min=1e-30)[:, None], 0.)


def emulate_flash(q, k, v, *, causal, window):
    """B3 as the fp32 kernel decomposes it: q (B, Hq, Sq, dh), k/v (B, Hkv,
    Sk, dh) -> (B, Hq, Sq, dh) in q's dtype."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    r, M = Hq // Hkv, Sq * (Hq // Hkv)
    bn = KEY_TILE
    scale = LOG2E / math.sqrt(dh)
    out = torch.zeros(B, Hq, Sq, dh)
    for b in range(B):
        for hk in range(Hkv):
            # folded row j = position * r + head-in-group
            qf = q[b, hk * r:(hk + 1) * r].transpose(0, 1).reshape(M, dh)
            qf = qf.float() * scale
            kv = lambda keys: (k[b, hk, keys], v[b, hk, keys])
            for m0 in range(0, M, QUERY_TILE):
                rows = torch.arange(m0, min(m0 + QUERY_TILE, M))
                pos = rows // r
                hi = torch.clamp(pos + 1, max=Sk) if causal \
                    else torch.full_like(pos, Sk)
                lo = pos - window + 1 if window > 0 else torch.zeros_like(pos)
                # the tile's keys, from its first and last position
                kbeg = max(0, int(lo[0]))
                kend = max(0, int(hi[-1]))
                o = finish([attend_span(qf[rows], kv, lo, hi, kbeg, kend,
                                        bn, q.dtype)])
                out[b, hk * r + rows % r, pos] = o
    return out.to(q.dtype)


def emulate_decode(q, kpool, vpool, tables, lengths):
    """B2 as the kernel decomposes it: q (B, Hkv, r, dh) -> (B, Hkv, r, dh)
    in q's dtype."""
    B, Hkv, r, dh = q.shape
    slots, page, _ = kpool.shape
    max_pages = tables.shape[-1]
    n_splits, span = ops.split_plan(B, Hkv, 1, r, max_pages, page)
    scale = LOG2E / math.sqrt(dh)
    tables = tables.long().clamp(0, slots - 1)       # clamped per entry
    out = torch.zeros(B, Hkv, r, dh)
    for b in range(B):
        length = max(0, min(int(lengths[b]), max_pages * page))
        lo, hi = torch.zeros(r, dtype=torch.long), torch.full((r,), length)
        for h in range(Hkv):
            def kv(keys):
                slot = tables[b, h, keys // page]
                return kpool[slot, keys % page], vpool[slot, keys % page]
            qf = q[b, h].float() * scale
            parts = [attend_span(qf, kv, lo, hi, s * span,
                                 min(length, (s + 1) * span), SPLIT_KEY_TILE,
                                 q.dtype)
                     for s in range(n_splits)
                     if n_splits == 1 or s * span < length]  # live spans
            out[b, h] = finish(parts, n_splits > 1) if parts else 0.
    return out.to(q.dtype)


def inputs(shapes, dtype, seed):
    """The same random arrays as JAX and torch arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


# (B, Hq, Hkv, Sq, Sk, dh, causal, window, Pallas block): the cases of
# tests/test_torch_flash.py, then r = 5 with a position's rows split
# across two 64-row tiles (row 64 is position 12's fifth head), a window
# at r = 5 over several key tiles, and keys shorter than the queries
FLASH_CASES = {
    "mha": (1, 4, 4, 128, 128, 64, True, 0, 64),
    "gqa_r4": (2, 8, 2, 256, 256, 64, True, 0, 64),
    "mqa": (1, 4, 1, 128, 128, 128, True, 0, 64),
    "seq192_dh32": (2, 4, 2, 192, 192, 32, True, 0, 64),
    "window16": (1, 4, 2, 128, 128, 32, True, 16, 32),
    "window96": (1, 4, 2, 128, 128, 32, True, 96, 32),
    "noncausal_100": (1, 2, 2, 100, 100, 32, False, 0, 64),
    "r5_straddle": (1, 10, 2, 30, 30, 64, True, 0, 64),
    "r5_window": (1, 10, 2, 150, 150, 64, True, 40, 64),
    "sq_gt_sk": (1, 10, 2, 50, 30, 64, True, 0, 64),
    "sq_gt_sk_window": (1, 10, 2, 60, 30, 64, True, 8, 64),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_emulation_matches_plain_and_pallas(name, dtype):
    B, Hq, Hkv, Sq, Sk, dh, causal, window, blk = FLASH_CASES[name]
    (jq, jk, jv), (q, k, v) = inputs(
        [(B, Hq, Sq, dh), (B, Hkv, Sk, dh), (B, Hkv, Sk, dh)], dtype,
        sorted(FLASH_CASES).index(name))
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    kern = np.asarray(jflash(jq, jk, jv, causal=causal, window=window,
                             block_q=blk, block_k=blk), np.float32)
    # rows that see no key: 0 in the kernel and the plain version; the
    # Pallas kernel gives them the mean of V over a block it runs for
    # their neighbours (its P is not multiplied by the mask), so it is
    # compared on the other rows
    blind = (plain == 0).all(-1).numpy()
    assert blind.any() == (Sq > Sk + window > window > 0)
    if dtype == "bfloat16":          # the bf16 kernel's per-head design
        got = emulate_forward(q, k, v, causal=causal, window=window)[0]
    else:
        got = emulate_flash(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, plain.float().numpy(), **TOL[dtype])
    np.testing.assert_allclose(got[~blind], kern[~blind], **TOL[dtype])
    assert np.all(got[blind] == 0)


def test_flash_tiles_depend_on_shapes_alone():
    """BSHD and BHSD inputs fold to the same rows: the emulation of one
    is the emulation of the other, bit for bit (the fp32 kernel's folded
    rows; the bf16 kernel's tiles: test_torch_b3_fwd_design.py)."""
    _, (q, k, v) = inputs([(1, 10, 40, 64), (1, 2, 40, 64), (1, 2, 40, 64)],
                          "float32", 11)
    a = emulate_flash(q, k, v, causal=True, window=0)
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert torch.equal(a, emulate_flash(qs, ks, vs, causal=True, window=0))


def decode_case(seed, B, Hkv, r, dh, page, maxp, lengths, bad=False):
    rng = np.random.default_rng(seed)
    slots = B * Hkv * maxp + 3
    tables = rng.permutation(slots)[:B * Hkv * maxp].reshape(B, Hkv, maxp)
    lengths = np.asarray(lengths, np.int32)
    if bad:      # out-of-range ids past each length: the kernel clamps them
        need = (lengths + page - 1) // page
        for b in range(B):
            tables[b, :, need[b]:] = rng.choice(
                [-7, slots + 5], size=tables[b, :, need[b]:].shape)
    return dict(q=rng.standard_normal((B, Hkv, r, dh)).astype(np.float32),
                k=rng.standard_normal((slots, page, dh)).astype(np.float32),
                v=rng.standard_normal((slots, page, dh)).astype(np.float32),
                tables=tables.astype(np.int32), lengths=lengths)


# (shape, whether the plan splits it): ragged qwen-like contexts over 8
# spans with dead spans and a padded row, out-of-range table entries, MHA
# r = 1 at dh 96, r = 16, and a table of one key tile the plan leaves
# whole
DECODE_CASES = {
    "ragged": (dict(B=3, Hkv=2, r=5, dh=64, page=16, maxp=32,
                    lengths=[500, 0, 65]), True),
    "bad_tables": (dict(B=2, Hkv=2, r=5, dh=64, page=8, maxp=24,
                        lengths=[100, 7], bad=True), True),
    "mha_dh96": (dict(B=2, Hkv=2, r=1, dh=96, page=16, maxp=8,
                      lengths=[128, 33]), True),
    "r16": (dict(B=2, Hkv=1, r=16, dh=64, page=16, maxp=8,
                 lengths=[90, 1]), True),
    "lengths_past_table": (dict(B=2, Hkv=1, r=5, dh=64, page=8, maxp=24,
                                lengths=[10 ** 6, 20]), True),
    "unsplit": (dict(B=4, Hkv=2, r=2, dh=64, page=16, maxp=4,
                     lengths=[64, 0, 17, 1]), False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_emulation_matches_plain_and_pallas(name, dtype):
    shape, splits = DECODE_CASES[name]
    case = decode_case(sorted(DECODE_CASES).index(name), **shape)
    n_splits, _ = ops.split_plan(shape["B"], shape["Hkv"], 1, shape["r"],
                                 shape["maxp"], shape["page"])
    assert (n_splits > 1) == splits
    targs = [torch.from_numpy(case[x]).to(TDT[dtype]) for x in "qkv"] + [
        torch.from_numpy(case[x]) for x in ("tables", "lengths")]
    got = emulate_decode(*targs)
    assert got.shape == case["q"].shape
    got = got.float().numpy()
    slots = case["k"].shape[0]
    plain = paged_attention_ref(*targs[:3], targs[3].clamp(0, slots - 1),
                                targs[4]).float().numpy()
    np.testing.assert_allclose(got, plain, **TOL[dtype])
    jargs = [jnp.asarray(case[x], JDT[dtype]) for x in "qkv"] + [
        jnp.asarray(case[x]) for x in ("tables", "lengths")]
    kern = np.asarray(jax_decode(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    assert np.all(got[case["lengths"] == 0] == 0)


def test_decode_one_live_span_merges_exactly(monkeypatch):
    """Contexts inside the first span give bit for bit what the unsplit
    tile gives: the merge weights are 2^0 == 1."""
    shape, _ = DECODE_CASES["ragged"]
    case = decode_case(5, **dict(shape, lengths=[40, 0, 64]))
    targs = [torch.from_numpy(case[x]) for x in
             ("q", "k", "v", "tables", "lengths")]
    n_splits, span = ops.split_plan(3, 2, 1, 5, shape["maxp"], shape["page"])
    assert n_splits > 1 and span >= 64
    split = emulate_decode(*targs)
    monkeypatch.setattr(ops, "split_plan", lambda *a: (1, 512))
    assert torch.equal(split, emulate_decode(*targs))
    assert torch.all(split[1] == 0)
