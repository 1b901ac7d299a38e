"""B1's bf16 wgmma kernel (``csrc/paged_prefill_attention.cu``,
``paged_prefill_wgmma``) as it decomposes the work, in plain PyTorch.

Where C * r > 64 a block is one (row, kv head) and two or three consumer
groups of 64 folded rows (two at dh 96, and at dh 64 and 128 where blocks
of three would leave SMs of the card idle; else three); where C * r <= 64
it is one row and two kv heads, one group each.  Blocks run in the kernel's
launch order; each (row, kv head) of a block has one ring, a sequence of
64-key tiles to its last row's end, each tile's K and V gathered as the
producer's TMA boxes are: one box a page, from the table entry clamped
into the pool (slot 0 for pages past the table row), V's rows past the
row's length cleared in the last tile.  Each (group, tile) is classed
interior / masked / skipped from the group's first and last row alone, and
the class is checked pair by pair against the mask; every tile the block
does not walk is checked to hold no visible pair.  The softmax runs in
fp32 in log2 units (exp2 of the scores times log2(e) / sqrt(dh) less the
running maximum), l sums P unrounded and P is rounded to bf16 where it
meets V; O's product runs 64 columns an atom on V zero-filled past dh (128
wide at dh 96; the two-head blocks at dh 96 run it in 32-column atoms, 96
wide: the same sums).  Used by ``test_torch_b1_wgmma_design.py``."""

import math

import torch

LOG2E = 1.4426950408889634
SMS = 132                   # an H100's SMs, which the launch fills
ROWS = 64                   # folded rows of a consumer group
KEYS = 64                   # keys of a tile
SKIP, MASKED, INTERIOR = 0, 1, 2


def groups(dh, M, B, Hkv, sms=SMS):
    """Row groups of a (row, kv head) in a block: one where M <= 64, else
    two at dh 96, and three at dh 64 and 128 unless B * Hkv blocks of
    three groups would leave some of the card's ``sms`` SMs idle."""
    if M <= ROWS:
        return 1
    if dh == 96 or B * Hkv * -(-M // (3 * ROWS)) < sms:
        return 2
    return 3


def heads(M):
    """kv heads a block: two where M <= 64 (a group and a ring each), else
    one."""
    return 2 if M <= ROWS else 1


def key_end(j, length, start, r):
    """The keys folded row j sees: [0, key_end)."""
    return max(0, min(length, start + j // r + 1))


def launch_order(B, Hkv, M, dh, sms=SMS):
    """(row, kv heads, row block) of each block in launch order: grid
    (row blocks, kv head blocks, B), x fastest, the last (heaviest) rows
    first; a head block's heads past Hkv are left out."""
    n_pb = -(-M // (groups(dh, M, B, Hkv, sms) * ROWS))
    hd = heads(M)
    return [(b, tuple(range(hb, min(hb + hd, Hkv))), n_pb - 1 - x)
            for b in range(B) for hb in range(0, Hkv, hd)
            for x in range(n_pb)]


def group_walk(g0, M, length, start, r):
    """(c_hi, n_int): the group computes tiles [0, c_hi), the first n_int
    interior; a group of rows past M computes none."""
    if g0 >= M:
        return 0, 0
    c_hi = -(-key_end(min(g0 + ROWS, M) - 1, length, start, r) // KEYS)
    return c_hi, min(c_hi, key_end(g0, length, start, r) // KEYS)


def tile_class(tile, walk):
    c_hi, n_int = walk
    return INTERIOR if tile < n_int else MASKED if tile < c_hi else SKIP


def visible_pairs(g0, n, M, k0, length, start, r):
    """(rows < M of [g0, g0 + n), 64 keys) booleans: which pairs are
    seen."""
    rows = torch.arange(g0, max(g0, min(g0 + n, M)))
    ends = torch.clamp(start + rows // r + 1, max=length).clamp(min=0)
    return torch.arange(k0, k0 + KEYS)[None, :] < ends[:, None]


def check_class(cls, vis):
    """The class agrees with the tile's pairs: skipped holds no visible
    pair, interior only visible ones, masked both."""
    if cls == SKIP:
        assert not vis.any()
    elif cls == INTERIOR:
        assert vis.all()
    else:
        assert vis.any() and not vis.all()


def page_slots(tables_bh, tile, page, slots):
    """The producer's boxes of tile ``tile``: one slot a page, clamped into
    the pool; slot 0 for a page past the table row."""
    n = tables_bh.shape[0]
    pages = range(tile * KEYS // page, (tile + 1) * KEYS // page)
    return [min(max(int(tables_bh[i]), 0), slots - 1) if i < n else 0
            for i in pages]


def emulate(q, kpool, vpool, tables, lengths, starts, classes=None,
            sms=SMS):
    """(B, Hkv, C, r, dh) in q's dtype as the wgmma kernel computes it on
    a card of ``sms`` SMs; ``classes`` (a dict) counts the (group, tile)
    classes met."""
    B, Hkv, C, r, dh = q.shape
    slots, page, _ = kpool.shape
    max_pages = tables.shape[-1]
    assert KEYS % page == 0 and page * 128 % 1024 == 0   # whole boxes
    M = C * r
    nwg = groups(dh, M, B, Hkv, sms)
    counts = {} if classes is None else classes
    out = torch.zeros(B, C, Hkv, r, dh)
    all_tiles = -(-max_pages * page // KEYS)
    for b, block_heads, pb in launch_order(B, Hkv, M, dh, sms):
        length = max(0, min(int(lengths[b]), max_pages * page))
        start = int(starts[b])
        j0 = pb * nwg * ROWS
        n_tiles = -(-key_end(min(j0 + nwg * ROWS, M) - 1, length, start,
                             r) // KEYS)
        for kt in range(n_tiles, all_tiles):   # never read
            assert not visible_pairs(j0, nwg * ROWS, M, kt * KEYS, length,
                                     start, r).any()
        if n_tiles == 0:
            continue                            # zeros, and done
        for h in block_heads:
            emulate_ring(q, kpool, vpool, tables, out, counts, b, h, j0,
                         nwg, length, start, n_tiles)
    return out.to(q.dtype).transpose(1, 2)


def emulate_ring(q, kpool, vpool, tables, out, counts, b, h, j0, nwg,
                 length, start, n_tiles):
    """The nwg groups of (row b, kv head h) from folded row j0 over their
    ring of n_tiles key tiles, into out (B, C, Hkv, r, dh)."""
    B, Hkv, C, r, dh = q.shape
    slots, page, _ = kpool.shape
    M = C * r
    nv = 64 * -(-dh // 64)                   # O's product width
    sl2 = LOG2E / math.sqrt(dh)
    rnd = lambda x: x.to(torch.bfloat16).float()
    # the ring's tiles: K/V rows of each page box, V zero past dh and, in
    # the last tile, past the row's length (whatever the slot holds there)
    ring = []
    for kt in range(n_tiles):
        ss = page_slots(tables[b, h], kt, page, slots)
        K = torch.cat([kpool[s].float() for s in ss])
        V = torch.zeros(KEYS, nv)
        V[:, :dh] = torch.cat([vpool[s].float() for s in ss])
        if kt == n_tiles - 1:
            V[max(0, length - kt * KEYS):] = 0
        ring.append((K, V))
    qf = q[b, h].reshape(M, dh).float()
    for g in range(nwg):
        g0 = j0 + g * ROWS
        walk = group_walk(g0, M, length, start, r)
        rows = torch.arange(g0, max(g0, min(g0 + ROWS, M)))
        Q = qf[rows] if len(rows) else torch.zeros(0, dh)
        m = torch.full((len(rows),), -math.inf)
        l = torch.zeros(len(rows))
        o = torch.zeros(len(rows), nv)
        for kt, (K, V) in enumerate(ring):
            cls = tile_class(kt, walk)
            vis = visible_pairs(g0, ROWS, M, kt * KEYS, length, start, r)
            check_class(cls, vis)
            counts[cls] = counts.get(cls, 0) + 1
            if cls == SKIP:
                continue                    # the stage still released
            s = Q @ K.T
            if cls == MASKED:               # interior: no mask code
                s = torch.where(vis, s, -math.inf)
            t = torch.maximum(m, s.amax(-1) * sl2)
            base = torch.where(t == -math.inf, 0., t)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s * sl2 - base[:, None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[:, None] + rnd(p) @ V
            m = t
        if not len(rows):
            continue                        # rows past M: unwritten
        o = torch.where(l[:, None] > 0,
                        o / torch.where(l > 0, l, 1.)[:, None], 0.)
        out[b, rows // r, h, rows % r] = o[:, :dh]
