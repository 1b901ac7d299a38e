"""The decode tile (``csrc/paged_decode_tma.cuh``: B2's bf16 launches and
B1's at C * r <= 16, a page in ``ops.WGMMA_PAGES``) as it decomposes the
work, in plain PyTorch.

The live 64-key tiles of every (row, kv head) -- each walk up to its last
folded row's end, lengths clamped to the table -- are split over a
persistent grid by ``ops.tma_plan`` (the device's arithmetic: each (row,
kv head) weighs its tiles plus ``ops.TMA_HEAD_COST``, and block g of G =
min(grid, U) takes the tiles of units [g U / G, (g + 1) U / G)).  Each
block walks its segments: a tile's K and V are gathered as the
producer's TMA boxes are, one box a page from the table
entry clamped into the pool (slot 0 for pages past the table row), V's
rows past the row's length cleared; each tile is classed interior or
masked from the rows' least end and the class checked pair by pair.  Each
of the block's four consumer warps takes its 16 keys of every tile with an
online softmax of its own, in fp32 in log2 units (exp2 of the scores
times log2(e) / sqrt(dh) less the running maximum), l summing P unrounded
and P rounded to the input type where it meets V; at the segment's end
the four (m, l, acc) are combined in warp order.  A segment that covers its
(row, kv head) writes the output; the others leave (m, l, acc) in their
slot and take a ticket, and the last taker merges the pieces in span order
(``ops.tma_pieces``) and resets the ticket.  Used by
``test_torch_decode_tma_design.py``."""

import math
import random

import torch

from repro_torch.kernels.paged_attention import ops

LOG2E = 1.4426950408889634
KEYS = ops.TMA_KEYS
WARPS = 4                                   # consumer warps a block
GRID = ops.TMA_BLOCKS_PER_SM * 132          # an H100's grid
MASKED, INTERIOR = 1, 2


def key_ends(M, r, length, start):
    """(M,) the keys each folded row sees: [0, end); ``start`` None in
    decode."""
    rows = torch.arange(M)
    if start is None:
        return torch.full((M,), length)
    return torch.clamp(start + rows // r + 1, max=length).clamp(min=0)


def tile_kv(kpool, vpool, tables_bh, tile, length):
    """K and V (64, dh) fp32 of walk tile ``tile``: one box a page, from
    its entry clamped into the pool (slot 0 past the table row); V's rows
    past the length cleared."""
    slots, page, _ = kpool.shape
    n = tables_bh.shape[0]
    ss = [min(max(int(tables_bh[i]), 0), slots - 1) if i < n else 0
          for i in range(tile * KEYS // page, (tile + 1) * KEYS // page)]
    K = torch.cat([kpool[s].float() for s in ss])
    V = torch.cat([vpool[s].float() for s in ss])
    V[max(0, length - tile * KEYS):] = 0
    return K, V


def walk(Q, ends, tiles, rnd, sl2, classes=None):
    """One segment: the M rows ``Q`` (fp32) over ``tiles``, a list of
    (first key, K, V), by the block's consumer warps, combined; returns
    the unnormalised fp32 (m, l, acc)."""
    for k0, _, _ in tiles:
        vis = torch.arange(k0, k0 + KEYS)[None, :] < ends[:, None]
        assert vis[-1, 0], "a walked tile holds a key the last row sees"
        masked = k0 + KEYS > int(ends.min())     # -inf past each end
        assert masked != bool(vis.all())
        if classes is not None:
            cls = MASKED if masked else INTERIOR
            classes[cls] = classes.get(cls, 0) + 1
    part = KEYS // WARPS
    return combine([walk_keys(Q, ends, tiles, rnd, sl2, w * part,
                              (w + 1) * part) for w in range(WARPS)])


def walk_keys(Q, ends, tiles, rnd, sl2, lo, hi):
    """One consumer warp's walk: keys [lo, hi) of every tile."""
    M = Q.shape[0]
    m = torch.full((M,), -math.inf)
    l = torch.zeros(M)
    o = torch.zeros(M, Q.shape[1])
    for k0, K, V in tiles:
        keys = torch.arange(k0 + lo, k0 + hi)
        vis = keys[None, :] < ends[:, None]
        K, V = K[lo:hi], V[lo:hi]
        s = Q @ K.T
        if k0 + KEYS > int(ends.min()):      # masked tile: the select
            s = torch.where(vis, s, -math.inf)
        t = torch.maximum(m, s.amax(-1) * sl2)
        base = torch.where(t == -math.inf, 0., t)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * sl2 - base[:, None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[:, None] + rnd(p) @ V
        m = t
    return m, l, o


def finish(m, l, o):
    """out = acc / l, exactly 0 where l == 0."""
    return torch.where(l[:, None] > 0,
                       o / torch.where(l > 0, l, 1.)[:, None], 0.)


def combine(pieces):
    """Several (m, l, acc) in order as one: M = max m, weights 2^(m - M)
    (0 for a row that saw no key in a piece): the consumer warps' at a
    segment's end, and the pieces of a crossing (row, kv head)."""
    m = torch.stack([p[0] for p in pieces])
    top = m.amax(0)
    w = torch.where(m == -math.inf, 0., torch.exp2(m - top))
    l = sum(wi * p[1] for wi, p in zip(w, pieces))
    acc = sum(wi[:, None] * p[2] for wi, p in zip(w, pieces))
    return top, l, acc


def merge(pieces):
    """The pieces of a crossing (row, kv head) in span order."""
    return finish(*combine(pieces))


def emulate(q, kpool, vpool, tables, lengths, starts=None, grid=GRID,
            order=None, classes=None, trace=None):
    """The decode tile's output in q's dtype: decode q (B, Hkv, r, dh)
    (``starts`` None) gives (B, Hkv, r, dh); chunk q (B, Hkv, C, r, dh)
    gives (B, Hkv, C, r, dh) as the transposed view of (B, C, Hkv, r, dh).
    ``order``: a random.Random that shuffles the order in which the blocks'
    segments finish (each block's own in order); ``classes`` counts the
    tile classes; ``trace`` (a dict) gets the plan, the slots written, the
    merges and the tickets left."""
    decode = starts is None
    qq = q[:, :, None] if decode else q
    B, Hkv, C, r, dh = qq.shape
    M = C * r
    slots, page, _ = kpool.shape
    max_pages = tables.shape[-1]
    assert KEYS % page == 0 and page * 128 % 1024 == 0   # whole boxes
    sl2 = LOG2E / math.sqrt(dh)
    rnd = lambda x: x.to(q.dtype).float()
    nts = ops.tma_row_tiles(lengths, starts, C, max_pages, page)
    U, G, walks = ops.tma_plan(nts, Hkv, grid)
    units = ops.tma_head_units(nts, Hkv)
    out = torch.full((B, C, Hkv, r, dh), math.nan)
    for b, nt in enumerate(nts):                  # no tile: zeros
        if nt == 0:
            out[b] = 0

    def segment(b, h, t0, t1):
        length = max(0, min(int(lengths[b]), max_pages * page))
        start = None if decode else int(starts[b])
        Q = qq[b, h].reshape(M, dh).float()
        tiles = [(k * KEYS, *tile_kv(kpool, vpool, tables[b, h], k, length))
                 for k in range(t0, t1)]
        return walk(Q, key_ends(M, r, length, start), tiles, rnd, sl2,
                    classes)

    # each block's segments, computed, then finished in `order`
    events = []
    for g, segs in enumerate(walks):
        for i, (b, h, t0, t1, slot) in enumerate(segs):
            events.append((g, i, b, h, slot, segment(b, h, t0, t1)))
    if order is not None:
        pending = {g: [e for e in events if e[0] == g] for g in range(G)}
        events = []
        while any(pending.values()):
            g = order.choice([g for g, es in pending.items() if es])
            events.append(pending[g].pop(0))
    scratch, tickets, merged = {}, {}, []
    for g, i, b, h, slot, (m, l, o) in events:
        nt = nts[b]
        if slot is None:                         # covered: written here
            res = finish(m, l, o)
        else:
            assert slot not in scratch
            scratch[slot] = (m, l, o)
            taken = tickets.get((b, h), 0)
            pieces = ops.tma_pieces(units[(b, h)], nt, U, G)
            if taken < len(pieces) - 1:
                tickets[(b, h)] = taken + 1
                continue
            tickets[(b, h)] = 0                  # the last: reset, merge
            merged.append(((b, h), pieces))
            res = merge([scratch[s] for s in pieces])
        out[b, :, h] = res.reshape(C, r, dh)
    if trace is not None:
        trace.update(U=U, G=G, walks=walks, slots=sorted(scratch),
                     merged=merged, tickets=tickets)
    got = out.to(q.dtype)
    return got[:, 0] if decode else got.transpose(1, 2)


def unsplit(q, kpool, vpool, tables, lengths, b, h, starts=None):
    """(row b, kv head h) walked whole by one block, in q's dtype:
    (r, dh) in decode, else (C, r, dh)."""
    decode = starts is None
    qq = q[:, :, None] if decode else q
    _, _, C, r, dh = qq.shape
    page = kpool.shape[1]
    max_pages = tables.shape[-1]
    length = max(0, min(int(lengths[b]), max_pages * page))
    nt = ops.tma_row_tiles(lengths, starts, C, max_pages, page)[b]
    tiles = [(k * KEYS, *tile_kv(kpool, vpool, tables[b, h], k, length))
             for k in range(nt)]
    ends = key_ends(C * r, r, length, None if decode else int(starts[b]))
    m, l, o = walk(qq[b, h].reshape(C * r, dh).float(), ends, tiles,
                   lambda x: x.to(q.dtype).float(), LOG2E / math.sqrt(dh))
    res = finish(m, l, o).reshape(C, r, dh).to(q.dtype)
    return res[0] if decode else res


def shuffled(seed):
    return random.Random(seed)
