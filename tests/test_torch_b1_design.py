"""The chunked-prefill kernel's (B1's) tensor-core design, held on the CPU.

``emulate`` repeats the CUDA kernel's decomposition in plain PyTorch:
query tiles and key tiles of the kernel's sizes, the key spans of the
wrapper's split plan, a per-span online softmax in fp32 (log2 units) with
P rounded to the working type before PV, and the merge of the spans.  It
is held against the port's plain version and the reference's Pallas
kernel (interpret mode) on inputs made with numpy from a seed, and the
split plan is checked as a pure function of shapes.  Tolerances: fp32
2e-5 (the same function summed in another order), bf16 2e-2 (P rounded
to bf16 before PV, which the plain version does not do)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention import (paged_prefill_attention as
                                           jax_paged_prefill)
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import \
    paged_prefill_attention_ref
from repro_torch.serving.engine import EngineConfig, _pow2s

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NEG_INF = -1e30
LOG2E = 1.4426950408889634
# the kernel's tiles (csrc/paged_prefill_attention.cu): folded query rows
# per block and keys per tile, by dtype, and the same for a split tile
QUERY_TILE = 64
KEY_TILE = {torch.bfloat16: 64, torch.float32: 32}
SPLIT_KEY_TILE = 32


def emulate(q, kpool, vpool, tables, lengths, starts):
    """B1 as the kernel decomposes it; returns (B, Hkv, C, r, dh) in q's
    dtype, the transposed view of a (B, C, Hkv, r, dh) tensor."""
    B, Hkv, C, r, dh = q.shape
    slots, page, _ = kpool.shape
    max_pages = tables.shape[-1]
    S, M = max_pages * page, C * r
    n_splits, span = ops.split_plan(B, Hkv, C, r, max_pages, page)
    if M <= ops.SPLIT_ROWS:
        bm, bn = ops.SPLIT_ROWS, SPLIT_KEY_TILE
    else:
        bm, bn = QUERY_TILE, KEY_TILE[q.dtype]
    scale = LOG2E / math.sqrt(dh)
    tables = tables.long().clamp(0, slots - 1)       # clamped per entry
    out = torch.zeros(B, C, Hkv, r, dh)
    for b in range(B):
        length = max(0, min(int(lengths[b]), S))
        start = int(starts[b])
        for h in range(Hkv):
            qf = q[b, h].reshape(M, dh).float()
            for m0 in range(0, M, bm):
                rows = torch.arange(m0, min(m0 + bm, M))
                # keys < lim are visible to a row; the tile's loop ends at
                # the last key any of its rows sees
                lim = torch.clamp(start + rows // r + 1, max=length)
                kend = max(0, min(length, start + int(rows[-1]) // r + 1))
                parts = []
                for s in range(n_splits):
                    k_lo, k_hi = s * span, min(kend, (s + 1) * span)
                    if n_splits > 1 and k_lo >= kend:
                        continue                     # a dead span
                    m = torch.full((len(rows),), NEG_INF)
                    l = torch.zeros(len(rows))
                    acc = torch.zeros(len(rows), dh)
                    for k0 in range(k_lo, k_hi, bn):
                        keys = torch.arange(k0, k0 + bn)
                        live = keys < k_hi           # the rest zero-filled
                        kk = torch.where(live, keys, 0)
                        slot = tables[b, h, kk // page]
                        K = torch.where(live[:, None],
                                        kpool[slot, kk % page].float(), 0.)
                        V = torch.where(live[:, None],
                                        vpool[slot, kk % page].float(), 0.)
                        ok = keys[None, :] < lim[:, None]
                        sc = torch.where(ok, (qf[rows] @ K.T) * scale,
                                         NEG_INF)
                        m_new = torch.maximum(m, sc.amax(-1))
                        p = torch.exp2(sc - m_new[:, None]) * ok
                        alpha = torch.exp2(m - m_new)
                        l = alpha * l + p.sum(-1)
                        acc = alpha[:, None] * acc \
                            + p.to(q.dtype).float() @ V
                        m = m_new
                    parts.append((m, l, acc))
                if n_splits == 1:
                    m, l, acc = parts[0]
                    o = acc / torch.where(l > 0, l, 1.)[:, None]
                elif not parts:                      # no live span
                    o = torch.zeros(len(rows), dh)
                else:
                    ms = torch.stack([pm for pm, _, _ in parts])
                    w = torch.exp2(ms - ms.amax(0))
                    lsum = (w * torch.stack([pl for _, pl, _ in parts])).sum(0)
                    osum = (w[..., None] * torch.stack(
                        [pa for _, _, pa in parts])).sum(0)
                    o = torch.where(lsum[:, None] > 0,
                                    osum / lsum.clamp(min=1e-30)[:, None], 0.)
                out[b, rows // r, h, rows % r] = o
    return out.to(q.dtype).transpose(1, 2)


def make_case(seed, B, Hkv, C, r, dh, page, maxp, starts, lengths):
    rng = np.random.default_rng(seed)
    slots = B * Hkv * maxp + 3
    tables = rng.permutation(slots)[:B * Hkv * maxp].reshape(B, Hkv, maxp)
    return dict(
        q=rng.standard_normal((B, Hkv, C, r, dh)).astype(np.float32),
        k=rng.standard_normal((slots, page, dh)).astype(np.float32),
        v=rng.standard_normal((slots, page, dh)).astype(np.float32),
        tables=tables.astype(np.int32),
        lengths=np.asarray(lengths, np.int32),
        starts=np.asarray(starts, np.int32))


# (shape, whether the plan splits it)
CASES = {
    # decode rows over 512-key tables: 8 spans of 64; row 1's context
    # leaves 5 spans dead
    "decode_split": (dict(B=2, Hkv=2, C=1, r=5, dh=64, page=16, maxp=32,
                          starts=[499, 129], lengths=[500, 130]), True),
    # 15 rows in one split tile: row 0's span 2 (keys 128-191) is in the
    # future of its first two tokens; row 1's keys 13-199 are in every
    # token's future, so spans 1-3 are dead though below the length
    "span_in_future": (dict(B=2, Hkv=2, C=3, r=5, dh=64, page=16, maxp=16,
                            starts=[126, 10], lengths=[129, 200]), True),
    # lengths past the table: only its 192 keys are seen
    "lengths_past_table_split": (dict(B=2, Hkv=1, C=2, r=5, dh=64, page=8,
                                      maxp=24, starts=[10 ** 5, 40],
                                      lengths=[10 ** 6, 10 ** 6]), True),
    "lengths_past_table": (dict(B=2, Hkv=1, C=16, r=4, dh=64, page=8,
                                maxp=8, starts=[10 ** 5, 3],
                                lengths=[10 ** 6, 10 ** 6]), False),
    # a fused-step bucket: a decode row, a chunk and a padded row; 80
    # rows in a 64- and a 16-row tile; 64-key tiles over 8-key pages
    "mixed_bucket": (dict(B=3, Hkv=2, C=16, r=5, dh=64, page=8, maxp=16,
                          starts=[100, 0, 0], lengths=[101, 16, 0]), False),
    "mha_dh96": (dict(B=2, Hkv=2, C=20, r=1, dh=96, page=16, maxp=8,
                      starts=[0, 77], lengths=[20, 90]), False),
    "starts_past_lengths": (dict(B=2, Hkv=2, C=4, r=5, dh=64, page=16,
                                 maxp=8, starts=[50, 30],
                                 lengths=[20, 31]), False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_plain_and_pallas(name, dtype):
    shape, splits = CASES[name]
    case = make_case(sorted(CASES).index(name), **shape)
    n_splits, _ = ops.split_plan(shape["B"], shape["Hkv"], shape["C"],
                                 shape["r"], shape["maxp"], shape["page"])
    assert (n_splits > 1) == splits
    targs = [torch.from_numpy(case[k]) for k in ("q", "k", "v")]
    targs = [t.to(TDT[dtype]) for t in targs] + [
        torch.from_numpy(case[k]) for k in ("tables", "lengths", "starts")]
    got = emulate(*targs)
    assert got.shape == case["q"].shape
    assert got.transpose(1, 2).is_contiguous()
    got = got.float().numpy()
    ref = paged_prefill_attention_ref(*targs).float().numpy()
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    jargs = [jnp.asarray(case[k], JDT[dtype]) for k in ("q", "k", "v")] + [
        jnp.asarray(case[k]) for k in ("tables", "lengths", "starts")]
    kern = np.asarray(jax_paged_prefill(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    padded = case["lengths"] == 0
    assert np.all(got[padded] == 0)


def test_one_live_span_merges_exactly(monkeypatch):
    """A split whose rows see one live span gives bit for bit what the
    unsplit tile gives: the merge weights are 2^0 == 1."""
    shape, _ = CASES["decode_split"]
    case = make_case(5, **dict(shape, starts=[40, 7], lengths=[41, 8]))
    targs = [torch.from_numpy(case[k]) for k in
             ("q", "k", "v", "tables", "lengths", "starts")]
    split = emulate(*targs)
    monkeypatch.setattr(ops, "split_plan", lambda *a: (1, 512))
    assert torch.equal(split, emulate(*targs))


def spans(n, span):
    return [(s * span, (s + 1) * span) for s in range(n)]


@pytest.mark.parametrize("C, r", [(1, 1), (1, 5), (2, 5), (3, 5), (1, 16),
                                  (4, 5), (64, 5), (16, 1), (17, 1)])
def test_split_plan_covers_the_table_once(C, r):
    for B in (1, 2, 3, 16, 32):
        for Hkv in (1, 2, 8, 32):
            for max_pages in (1, 3, 8, 128, 129):
                for page in (8, 16):
                    S = max_pages * page
                    n, span = ops.split_plan(B, Hkv, C, r, max_pages, page)
                    assert n >= 1 and span % ops.SPAN_ALIGN == 0
                    for key_tile in (*KEY_TILE.values(), SPLIT_KEY_TILE):
                        assert span % key_tile == 0
                    # every key in exactly one span, no span wholly past S
                    cover = spans(n, span)
                    assert cover[0][0] == 0 and cover[-1][1] >= S
                    assert cover[-1][0] < S
                    if C * r > ops.SPLIT_ROWS:
                        assert n == 1        # more than one small tile
                    else:
                        # about SPLIT_BLOCKS blocks (spans are rounded up
                        # to whole tiles, so at least half of them), or a
                        # span per key tile
                        tiles = -(-S // ops.SPAN_ALIGN)
                        assert 2 * B * Hkv * n >= min(ops.SPLIT_BLOCKS,
                                                      B * Hkv * tiles)


def test_split_scratch_at_the_largest_fused_bucket():
    """The fp32 partials of every fused-step bucket shape of the engine
    the chip run serves (max_batch 16, max_seq 2048, chunks <= 64, page
    16) at qwen3-14b's widths: at most 5,324,800 bytes (B 16, C 2,
    8 spans of 256 keys), a tenth of one layer's K/V at that bucket."""
    cfg = get_config("qwen3-14b")
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    r = cfg.n_heads // Hkv
    ecfg = EngineConfig(max_batch=16, max_seq=2048, prefill_chunk=64)
    max_pages = -(-ecfg.max_seq // ecfg.page_size)
    worst = (-1, ())
    for B in _pow2s(ecfg.max_batch):
        for C in _pow2s(ecfg.prefill_chunk):
            for P in _pow2s(max_pages):
                n, _ = ops.split_plan(B, Hkv, C, r, P, ecfg.page_size)
                nbytes = 4 * ops.split_scratch_floats(B, Hkv, C, r, dh, n)
                if C * r > ops.SPLIT_ROWS:
                    assert nbytes == 0
                worst = max(worst, (nbytes, (B, C, P, n)))
    assert worst == (5_324_800, (16, 2, 128, 8))
    kv_bytes = 16 * Hkv * max_pages * ecfg.page_size * dh * 2 * 2
    assert worst[0] <= kv_bytes / 10
    # it grows with the blocks the plan aims at, not with spans x C*r x dh
    bound = (ops.SPLIT_BLOCKS + 16 * Hkv) * ops.SPLIT_ROWS * (dh + 2) * 4
    assert worst[0] <= bound
