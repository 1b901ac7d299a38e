"""B3's bf16 forward (``csrc/flash_attention.cu``, ``fwd_wgmma``) as the
kernel decomposes it, in plain PyTorch: per query head, blocks of two or
three consumer groups of 64 positions, key tiles of 64 (128 at dh 64), each
(64 positions, key tile) classed from positions alone -- interior (every
pair visible: no mask), masked, skipped -- and the class checked against
the mask pair by pair; every key tile a block does not walk checked to hold
no visible pair.  The softmax runs in fp32 in log2 units (exp2 of the
scores times log2(e) / sqrt(dh) less the running maximum), l sums P
unrounded and P is rounded to bf16 where it meets V, as the kernel's
shared-memory A operand is.  Shared by ``test_torch_b3_fwd_design.py`` and
``test_torch_b3_b2_design.py``."""

import math

import torch

LOG2E = 1.4426950408889634
ROWS = 64                   # positions of a consumer group
SKIP, MASKED, INTERIOR = 0, 1, 2


def groups(dh):
    """Consumer groups a block: three at dh 64 and 128, two at 80, 96 and
    MLA's 192."""
    return 3 if dh in (64, 128) else 2


def key_tile(dh):
    """Keys a tile: 128 at dh 64 (S in 64 registers a thread beside O's
    32), 64 above."""
    return 128 if dh == 64 else 64


def band(causal, window):
    """The offsets q_pos - k_pos a row sees: [dmin, dmax]."""
    return (0 if causal else -(1 << 30), window - 1 if window > 0 else 1 << 30)


def tile_class(q0, k0, nk, Sq, Sk, causal, window):
    """The kernel's class of positions [q0, q0 + 64) by keys [k0, k0 + nk):
    from the tile's corners alone."""
    dmin, dmax = band(causal, window)
    qb, kb = min(q0 + ROWS, Sq) - 1, min(k0 + nk, Sk) - 1
    if qb < q0 or kb < k0:
        return SKIP
    lo, hi = q0 - kb, qb - k0
    if hi < dmin or lo > dmax:
        return SKIP
    full = q0 + ROWS <= Sq and k0 + nk <= Sk
    return INTERIOR if full and lo >= dmin and hi <= dmax else MASKED


def visible_pairs(q0, nq, k0, nk, Sq, Sk, causal, window):
    """(nq, nk) booleans: which (position, key) pairs of the tile are seen
    (positions or keys past the end: not)."""
    dmin, dmax = band(causal, window)
    q = torch.arange(q0, q0 + nq)[:, None]
    kk = torch.arange(k0, k0 + nk)[None, :]
    return (q < Sq) & (kk < Sk) & (q - kk >= dmin) & (q - kk <= dmax)


def check_class(cls, vis):
    """The class agrees with the tile's pairs: skipped holds no visible
    pair, interior only visible ones, masked both."""
    if cls == SKIP:
        assert not vis.any()
    elif cls == INTERIOR:
        assert vis.all()
    else:
        assert vis.any() and not vis.all()


def key_span(p0, p1, Sq, Sk, causal, window):
    """The keys positions [p0, p1) see, [lo, hi) (empty when hi <= lo), as
    the kernel bounds a block's walk and a group's own tiles."""
    p1 = min(p1, Sq)
    lo = max(0, p0 - window + 1) if window > 0 else 0
    hi = 0 if p1 <= p0 else min(Sk, p1) if causal else Sk
    return lo, hi


def tiles(span, kn):
    """The key tiles a span of keys meets."""
    lo, hi = span
    return range(lo // kn, -(-hi // kn)) if hi > lo else range(0)


def launch_order(B, Hq, r, Sq, Sk, dqk, dv):
    """(batch, head, position block) of each block of the kernel's 1-D
    grid, in launch order: groups of as many (batch, kv head)s' query heads
    as keep their K and V within 24 MB; in a group, position blocks last
    (heaviest) first, the group's heads fastest."""
    n_pb = -(-Sq // (groups(dqk) * ROWS))
    heads = min(B * Hq, max(1, (24 << 20) // (max(Sk, 1) * (dqk + dv) * 2))
                * r)
    order = []
    for blk in range(B * Hq * n_pb):
        grp, i = divmod(blk, heads * n_pb)
        g_heads = min(heads, B * Hq - grp * heads)
        bh = grp * heads + i % g_heads
        order.append((bh // Hq, bh % Hq, n_pb - 1 - i // g_heads))
    return order


def emulate_forward(q, k, v, *, causal, window, classes=None):
    """(out in q's dtype, lse (B, Hq, Sq) fp32, natural log) as the bf16
    kernel computes them from q (B, Hq, Sq, dh), k (B, Hkv, Sk, dh), v
    (B, Hkv, Sk, dv); ``classes`` (a dict) counts the tile classes met."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    r, kn = Hq // Hkv, key_tile(dh)
    sl2 = LOG2E / math.sqrt(dh)
    counts = {} if classes is None else classes
    rnd = lambda x: x.to(torch.bfloat16).float()
    out = torch.zeros(B, Hq, Sq, dv)
    lse = torch.full((B, Hq, Sq), -math.inf)

    def rows(x, b, h, p0, n, S):            # TMA's box: zeros past S
        idx = torch.arange(p0, p0 + n)
        live = (idx < S)[:, None]
        return torch.where(live, x[b, h, idx.clamp(max=S - 1)].float(), 0.)

    for b, h, pb in launch_order(B, Hq, r, Sq, Sk, dh, dv):
        hk, m0 = h // r, pb * groups(dh) * ROWS
        walked = tiles(key_span(m0, m0 + groups(dh) * ROWS, Sq, Sk,
                                causal, window), kn)
        for kt in range(-(-Sk // kn)):
            if kt not in walked:
                assert not visible_pairs(m0, groups(dh) * ROWS, kt * kn,
                                         kn, Sq, Sk, causal,
                                         window).any()
        for g in range(groups(dh)):
            p0 = m0 + g * ROWS
            own = tiles(key_span(p0, p0 + ROWS, Sq, Sk, causal,
                                 window), kn)
            Q = rows(q, b, h, p0, ROWS, Sq)
            m = torch.full((ROWS,), -math.inf)
            l = torch.zeros(ROWS)
            o = torch.zeros(ROWS, dv)
            for kt in walked:
                k0 = kt * kn
                cls = tile_class(p0, k0, kn, Sq, Sk, causal, window)
                vis = visible_pairs(p0, ROWS, k0, kn, Sq, Sk, causal,
                                    window)
                check_class(cls, vis)
                # a group computes the tiles between its own
                # first and last key and skips the walk's others
                assert (cls != SKIP) == (kt in own)
                counts[cls] = counts.get(cls, 0) + 1
                if cls == SKIP:
                    continue
                s = Q @ rows(k, b, hk, k0, kn, Sk).T
                if cls == MASKED:     # interior tiles: no mask code
                    s = torch.where(vis, s, -math.inf)
                t = torch.maximum(m, s.amax(-1) * sl2)
                base = torch.where(t == -math.inf, 0., t)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s * sl2 - base[:, None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[:, None] \
                    + rnd(p) @ rows(v, b, hk, k0, kn, Sk)
                m = t
            pos = torch.arange(p0, p0 + ROWS)
            live = pos < Sq
            seen = l > 0
            o = torch.where(seen[:, None],
                            o / torch.where(seen, l, 1.)[:, None], 0.)
            out[b, h, pos[live]] = o[live]
            lse[b, h, pos[live]] = torch.where(
                seen, (m + torch.log2(torch.where(seen, l, 1.)))
                / LOG2E, -math.inf)[live]
    return out.to(q.dtype), lse
