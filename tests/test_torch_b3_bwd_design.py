"""The design of B3's backward (``csrc/flash_attention_bwd.cu``), held on
the CPU.

``emulate_backward`` repeats the kernels' decomposition in plain PyTorch:
D = rowsum(dO * O) and each row's lse in log2 units; P recomputed from
them, dV += P^T dO, dS = P * (dP - D), dK += dS^T Q * scale in the dK/dV
pass and dQ += dS K * scale in the dQ pass.

fp32 (the CUDA-core kernels): the dK/dV pass over blocks of 64 keys of
one (batch, kv head), each walking the tiles of folded query rows
(position * r + head-in-group; 64 rows, 32 at dh 128) that can see one of
its keys; the dQ pass over tiles of 64 folded rows, walking the key tiles
(32 keys) they see.

bf16 (the wgmma kernels): per query head, 64 x 64 tiles.  A dK/dV block
owns 128 keys of one (batch, kv head), a consumer group 64 of them, and
walks for each of the r query heads the 64-position tiles that see one of
the block's keys (above dh 64 once per 64-column chunk: the same sums); a
dQ block owns 64 positions per consumer group (three groups at dh 64, two
above) of one query head and walks the 64-key tiles they see, at MLA's
q/k 192 (v 128) in four parts of 16 keys.  Every tile
a group meets is classed from its positions and keys as the kernels class
it -- interior (every pair visible: no mask), masked, or skipped (no
visible pair) -- and the class is checked against the mask pair by pair;
P and dS are rounded to bf16 before their products, as the kernels'
shared-memory operands are.

Every tile the kernels do not walk is checked to hold no visible (row,
key) pair.  Held against autograd of the plain version
(``flash_attention_ref``) on inputs made with numpy from a seed: fp32 2e-5
and bf16 2e-2 of each gradient's largest magnitude."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
KEYS_PER_BLOCK = 64                         # fp32 dK/dV: 16 keys a warp
ROWS_PER_BLOCK = 64                         # fp32 dQ: 16 rows a warp
GROUP = 64             # bf16: keys (dK/dV) or positions (dQ) of a group
DKDV_GROUPS = 2        # bf16 dK/dV: consumer groups a block
SKIP, MASKED, INTERIOR = 0, 1, 2


def query_tile(dh):
    """Folded query rows per tile of the dK/dV pass."""
    return 32 if dh > 96 else 64


def key_tile(dtype):
    """Keys per tile of the dQ pass."""
    return 32 if dtype == torch.float32 else 64


def key_range(j, r, M, Sk, causal, window):
    """The keys folded rows ``j`` see: [lo, hi), hi = 0 past the rows."""
    pos = j // r
    lo = (pos - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(j)
    hi = pos.clamp(max=Sk - 1) + 1 if causal else torch.full_like(j, Sk)
    return torch.where(j < M, lo, 0), torch.where(j < M, hi, 0)


def plain_lse(q, k, causal, window):
    """The forward's log-sum-exp of each row's scaled, masked scores;
    -inf where a row sees no key."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(Hq // Hkv, dim=1)
    s = q.float() @ kr.transpose(-1, -2) / math.sqrt(dh)
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= qp - kp < window
    return torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)


def dq_groups(dh):
    """bf16 dQ: consumer groups a block."""
    return 3 if dh <= 64 else 2


def dq_part(dh):
    """bf16 dQ: keys of a tile per product (quarters at q/k 192)."""
    return 16 if dh > 128 else GROUP


def band(causal, window):
    """The offsets q_pos - k_pos a row sees: [dmin, dmax]."""
    return (0 if causal else -(1 << 30), window - 1 if window > 0 else 1 << 30)


def tile_class(q0, nq, k0, nk, Sq, Sk, causal, window):
    """The kernels' class of positions [q0, q0 + nq) by keys [k0, k0 + nk):
    from the tile's corners alone."""
    dmin, dmax = band(causal, window)
    qb, kb = min(q0 + nq, Sq) - 1, min(k0 + nk, Sk) - 1
    if qb < q0 or kb < k0:
        return SKIP
    lo, hi = q0 - kb, qb - k0
    if hi < dmin or lo > dmax:
        return SKIP
    full = q0 + nq <= Sq and k0 + nk <= Sk
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


def emulate_bf16_design(q, k, v, out, lse, dout, *, causal, window,
                        classes=None):
    """(dq, dk, dv) as the bf16 wgmma kernels compute them, in fp32 with P
    and dS rounded to bf16 where they meet a product; ``classes`` (a dict)
    counts the tile classes met."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    r = Hq // Hkv
    sl2 = LOG2E / math.sqrt(dh)
    scale = 1.0 / math.sqrt(dh)
    rnd = lambda x: x.to(torch.bfloat16).float()
    counts = {} if classes is None else classes
    lse2 = torch.where(torch.isinf(lse), torch.inf, lse * LOG2E)
    delta = (dout.float() * out.float()).sum(-1)
    dq = torch.zeros(B, Hq, Sq, dh)
    dk = torch.zeros(B, Hkv, Sk, dh)
    dvv = torch.zeros(B, Hkv, Sk, dv)
    dmin, dmax = band(causal, window)
    nq = GROUP                              # positions per dK/dV tile

    def rows(x, b, h, p0, n, S):
        idx = torch.arange(p0, p0 + n)
        live = (idx < S)[:, None]
        return torch.where(live, x[b, h, idx.clamp(max=S - 1)].float(), 0.)

    def stats(b, h, p0, n):
        idx = torch.arange(p0, p0 + n)
        live = idx < Sq
        c = idx.clamp(max=Sq - 1)
        return (torch.where(live, lse2[b, h, c], torch.inf),
                torch.where(live, delta[b, h, c], 0.))

    def tile(b, h, hk, p0, k0, n_p, n_k):
        """P and dS of positions [p0, p0 + n_p) by keys [k0, k0 + n_k) of
        head h, classed and checked; None if skipped."""
        cls = tile_class(p0, n_p, k0, n_k, Sq, Sk, causal, window)
        vis = visible_pairs(p0, n_p, k0, n_k, Sq, Sk, causal, window)
        check_class(cls, vis)
        counts[cls] = counts.get(cls, 0) + 1
        if cls == SKIP:
            return None
        Qt, dOt = rows(q, b, h, p0, n_p, Sq), rows(dout, b, h, p0, n_p, Sq)
        Kt, Vt = rows(k, b, hk, k0, n_k, Sk), rows(v, b, hk, k0, n_k, Sk)
        l2, D = stats(b, h, p0, n_p)
        p = torch.exp2(Qt @ Kt.T * sl2 - l2[:, None])
        if cls == MASKED:                    # interior tiles: no mask code
            p = torch.where(vis, p, 0.)
        ds = p * (dOt @ Vt.T - D[:, None])
        return p, ds, Qt, dOt, Kt

    for b in range(B):
        for hk in range(Hkv):
            # dK/dV: blocks of DKDV_GROUPS x 64 keys, per query head the
            # tiles of nq positions that see one of the block's keys
            for n0 in range(0, Sk, DKDV_GROUPS * GROUP):
                n_hi = min(n0 + DKDV_GROUPS * GROUP, Sk)
                qt_lo = n0 // nq if causal else 0
                q_end = min(Sq, n_hi - 1 + window) if window > 0 else Sq
                walked = range(qt_lo, -(-q_end // nq)) \
                    if q_end > qt_lo * nq else range(0)
                for qt in range(-(-Sq // nq)):
                    if qt in walked:
                        continue
                    for h in range(hk * r, (hk + 1) * r):
                        assert not visible_pairs(qt * nq, nq, n0, n_hi - n0,
                                                 Sq, Sk, causal,
                                                 window).any()
                for g in range(DKDV_GROUPS):
                    k0 = n0 + g * GROUP
                    acc_k = torch.zeros(GROUP, dh)
                    acc_v = torch.zeros(GROUP, dv)
                    for h in range(hk * r, (hk + 1) * r):
                        for qt in walked:
                            got = tile(b, h, hk, qt * nq, k0, nq, GROUP)
                            if got is None:
                                continue
                            p, ds, Qt, dOt, _ = got
                            acc_v += rnd(p).T @ dOt
                            acc_k += rnd(ds).T @ Qt
                    keys = torch.arange(k0, k0 + GROUP)
                    live = keys < Sk
                    dk[b, hk, keys[live]] = acc_k[live] * scale
                    dvv[b, hk, keys[live]] = acc_v[live]
        # dQ: blocks of groups x 64 positions of one head, the 64-key tiles
        # their positions see
        rows_per_block = dq_groups(dh) * GROUP
        for h in range(Hq):
            hk = h // r
            for m0 in range(0, Sq, rows_per_block):
                kbeg = max(0, m0 - dmax)
                kend = min(Sk, min(m0 + rows_per_block, Sq) - dmin)
                walked = range(kbeg // GROUP, -(-kend // GROUP)) \
                    if kend > kbeg else range(0)
                for kt in range(-(-Sk // GROUP)):
                    if kt not in walked:
                        assert not visible_pairs(m0, rows_per_block,
                                                 kt * GROUP, GROUP, Sq, Sk,
                                                 causal, window).any()
                for g in range(dq_groups(dh)):
                    p0 = m0 + g * GROUP
                    acc = torch.zeros(GROUP, dh)
                    for kt in walked:
                        got = tile(b, h, hk, p0, kt * GROUP, GROUP, GROUP)
                        if got is None:
                            continue
                        _, ds, _, _, Kt = got
                        n = dq_part(dh)
                        for c0 in range(0, GROUP, n):
                            acc += rnd(ds[:, c0:c0 + n]) @ Kt[c0:c0 + n]
                    pos = torch.arange(p0, p0 + GROUP)
                    live = pos < Sq
                    dq[b, h, pos[live]] = acc[live] * scale
    return dq, dk, dvv


def emulate_backward(q, k, v, out, lse, dout, *, causal, window):
    """(dq, dk, dv) as the three kernels compute them, in fp32: the bf16
    design's schedule for bf16 inputs, the fp32 kernels' otherwise."""
    if q.dtype == torch.bfloat16:
        return emulate_bf16_design(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    B, Hq, Sq, dh = q.shape
    Hkv, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    r, M = Hq // Hkv, Sq * (Hq // Hkv)
    scale = 1.0 / math.sqrt(dh)
    sl2 = scale * LOG2E
    bf16 = q.dtype == torch.bfloat16
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (lambda x: x)
    delta = (dout.float() * out.float()).sum(-1)           # the D pass
    lse2 = torch.where(torch.isinf(lse), torch.inf, lse * LOG2E)
    rng = lambda j: key_range(j, r, M, Sk, causal, window)
    dq = torch.zeros(B, Hq, Sq, dh)
    dk = torch.zeros(B, Hkv, Sk, dh)
    dvv = torch.zeros(B, Hkv, Sk, dv)
    nq, nk = query_tile(dh), key_tile(q.dtype)
    for b in range(B):
        for hk in range(Hkv):
            heads = slice(hk * r, (hk + 1) * r)
            fold = lambda x: x[b, heads].transpose(0, 1).reshape(
                M, *x.shape[3:]).float()
            qf, dof = fold(q), fold(dout)
            lf, df = fold(lse2[..., None])[:, 0], fold(delta[..., None])[:, 0]
            K, V = k[b, hk].float(), v[b, hk].float()

            def rows_of(j):
                jj = j.clamp(max=M - 1)
                live = (j < M)[:, None]
                return (torch.where(live, qf[jj], 0.),
                        torch.where(live, dof[jj], 0.),
                        torch.where(j < M, lf[jj], torch.inf),
                        torch.where(j < M, df[jj], 0.))

            # dK/dV: blocks of keys, each over the query tiles that see it
            for n0 in range(0, Sk, KEYS_PER_BLOCK):
                n_hi = min(n0 + KEYS_PER_BLOCK, Sk)
                keys = torch.arange(n0, n0 + KEYS_PER_BLOCK)
                Kt = torch.where((keys < Sk)[:, None], K[keys.clamp(
                    max=Sk - 1)], 0.)
                Vt = torch.where((keys < Sk)[:, None], V[keys.clamp(
                    max=Sk - 1)], 0.)
                j_lo = n0 * r if causal else 0
                j_hi = min(M, (n_hi - 1 + window) * r) if window > 0 else M
                tiles = range(j_lo // nq, -(-j_hi // nq)) \
                    if j_hi > j_lo else range(0)
                acc_k = torch.zeros(KEYS_PER_BLOCK, dh)
                acc_v = torch.zeros(KEYS_PER_BLOCK, dv)
                for qt in range(-(-M // nq)):
                    j = torch.arange(qt * nq, (qt + 1) * nq)
                    lo, hi = rng(j)
                    vis = (keys[:, None] >= lo[None]) \
                        & (keys[:, None] < hi[None])
                    if qt not in tiles:          # skipped: nothing visible
                        assert not vis.any(), (n0, qt)
                        continue
                    Qt, dOt, l2, D = rows_of(j)
                    pT = torch.where(vis, torch.exp2(
                        Kt @ Qt.T * sl2 - l2[None]), 0.)
                    dpT = Vt @ dOt.T
                    acc_v += rnd(pT) @ dOt
                    dsT = pT * (dpT - D[None])
                    acc_k += rnd(dsT) @ Qt
                live = keys < Sk
                dk[b, hk, keys[live]] = acc_k[live] * scale
                dvv[b, hk, keys[live]] = acc_v[live]
            # dQ: tiles of folded rows, each over the key tiles it sees
            for m0 in range(0, M, ROWS_PER_BLOCK):
                j = torch.arange(m0, m0 + ROWS_PER_BLOCK)
                lo, hi = rng(j)
                kbeg = int(rng(torch.tensor([m0]))[0])
                kend = int(rng(torch.tensor([min(m0 + ROWS_PER_BLOCK, M)
                                             - 1]))[1])
                allk = torch.arange(Sk)
                seen = (allk[None] >= lo[:, None]) & (allk[None] < hi[:, None])
                assert not seen[:, :kbeg].any() and not seen[:, kend:].any()
                Qt, dOt, l2, D = rows_of(j)
                acc = torch.zeros(ROWS_PER_BLOCK, dh)
                for k0 in range(kbeg, kend, nk):
                    keys = torch.arange(k0, k0 + nk)
                    live = keys < kend
                    Kt = torch.where(live[:, None], K[keys.clamp(
                        max=Sk - 1)], 0.)
                    Vt = torch.where(live[:, None], V[keys.clamp(
                        max=Sk - 1)], 0.)
                    vis = (keys[None] >= lo[:, None]) & (keys[None] < hi[:, None])
                    p = torch.where(vis, torch.exp2(
                        Qt @ Kt.T * sl2 - l2[:, None]), 0.)
                    ds = p * (dOt @ Vt.T - D[:, None])
                    acc += rnd(ds) @ Kt
                live = j < M
                jl = j[live]
                dq[b, hk * r + jl % r, jl // r] = acc[live] * scale
    return dq, dk, dvv


def inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             ).to(dtype) for s in shapes]


def plain_grads(q, k, v, dout, causal, window):
    """Autograd of the plain version in fp32."""
    qkv = [t.detach().float().requires_grad_() for t in (q, k, v)]
    o = flash_attention_ref(*qkv, causal=causal, window=window)
    return o.detach(), torch.autograd.grad(o, qkv, dout.float())


# (B, Hq, Hkv, Sq, Sk, dh, causal, window): MHA causal at dh 64 over
# several key blocks; GQA r = 5 (a position's rows split across tiles);
# dh 128 (32-row query tiles); dh 80 non-causal, S not a tile multiple;
# dh 96 with a window that skips query tiles on both sides; Sq > Sk +
# window (rows that see no key); Sq < Sk; and for the bf16 design's
# per-head tiles, whose causal diagonal runs corner to corner: a band of
# the diagonal and one key behind it (window 2) at dh 128 (two walks), a
# window edge that no tile boundary meets (window 200), GQA r = 5 over
# several key and position blocks (the folded rows' diagonal fell
# mid-tile); MLA's q/k 192 and v 128 (its own v width: V_DIMS) over
# several key blocks
CASES = {
    "mha_dh64": (1, 2, 2, 200, 200, 64, True, 0),
    "gqa_r5": (1, 10, 2, 70, 70, 64, True, 0),
    "gqa_dh128": (2, 4, 2, 100, 100, 128, True, 0),
    "noncausal_dh80": (1, 2, 2, 150, 150, 80, False, 0),
    "window_dh96": (1, 3, 1, 260, 260, 96, True, 40),
    "blind_rows": (1, 10, 2, 120, 50, 64, True, 16),
    "sq_lt_sk": (1, 4, 2, 40, 130, 64, True, 0),
    "diag_band": (1, 2, 2, 200, 200, 128, True, 2),
    "window_edge": (1, 2, 1, 330, 330, 64, True, 200),
    "gqa_r5_blocks": (1, 5, 1, 300, 300, 64, True, 0),
    "mla_192_128": (1, 4, 4, 260, 260, 192, True, 0),
}
V_DIMS = {"mla_192_128": 128}


def case_inputs(name, dtype, seed):
    """q, k, v, dout of case ``name`` (v and dout at its v width)."""
    B, Hq, Hkv, Sq, Sk, dh, _causal, _window = CASES[name]
    dv = V_DIMS.get(name, dh)
    return inputs([(B, Hq, Sq, dh), (B, Hkv, Sk, dh), (B, Hkv, Sk, dv),
                   (B, Hq, Sq, dv)], dtype, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_emulation_matches_plain_autograd(name, dtype):
    causal, window = CASES[name][6:]
    q, k, v, dout = case_inputs(name, dtype, sorted(CASES).index(name))
    out, want = plain_grads(q, k, v, dout, causal, window)
    lse = plain_lse(q, k, causal, window)
    blind = torch.isinf(lse)
    assert blind.any() == (name == "blind_rows")
    got = emulate_backward(q, k, v, out.to(dtype), lse, dout, causal=causal,
                           window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.isfinite(w).all()
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= TOL[dtype], (name, err)
    assert torch.all(got[0][blind] == 0) and torch.all(want[0][blind] == 0)


# the tile classes each case's bf16 schedule must meet
CLASSES_MET = {
    "mha_dh64": {SKIP, MASKED, INTERIOR},
    "diag_band": {SKIP, MASKED},
    "window_edge": {SKIP, MASKED, INTERIOR},
    "gqa_r5_blocks": {SKIP, MASKED, INTERIOR},
    "noncausal_dh80": {SKIP, MASKED, INTERIOR},   # groups past the end
    "blind_rows": {SKIP, MASKED},
    "mla_192_128": {SKIP, MASKED, INTERIOR},
}


@pytest.mark.parametrize("name", sorted(CLASSES_MET))
def test_bf16_design_meets_every_tile_class(name):
    """The cases hold the classes they are there for (each tile's class is
    checked against its pairs inside the emulation): a band of the
    diagonal leaves no interior tile, a causal diagonal from tile
    corner to corner one masked tile a row of tiles."""
    Sq, Sk = CASES[name][3:5]
    causal, window = CASES[name][6:]
    q, k, v, dout = case_inputs(name, torch.bfloat16, 11)
    out, _ = plain_grads(q, k, v, dout, causal, window)
    met = {}
    emulate_bf16_design(q, k, v, out.to(torch.bfloat16),
                        plain_lse(q, k, causal, window), dout,
                        causal=causal, window=window, classes=met)
    assert set(met) == CLASSES_MET[name], met
    if name == "mha_dh64":        # the diagonal tile, the one below, above
        assert tile_class(64, 64, 64, 64, Sq, Sk, True, 0) == MASKED
        assert tile_class(128, 64, 64, 64, Sq, Sk, True, 0) == INTERIOR
        assert tile_class(0, 64, 64, 64, Sq, Sk, True, 0) == SKIP


def test_cpu_wrapper_gradients_are_autograd_of_the_plain_version():
    """On CPU tensors ``flash_attention`` is the plain version and
    ``flash_attention_bwd`` autograd of it; rows that see no key get 0,
    not NaN."""
    q, k, v, dout = inputs([(1, 10, 60, 64), (1, 2, 30, 64),
                            (1, 2, 30, 64), (1, 10, 60, 64)],
                           torch.float32, 5)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*qkv, causal=True, window=8)
    o.backward(dout)
    got = ops.flash_attention_bwd(q, k, v, None, None, dout, causal=True,
                                  window=8)
    for g, t in zip(got, qkv):
        assert torch.equal(g, t.grad) and torch.isfinite(g).all()
    blind = torch.isinf(plain_lse(q, k, True, 8))
    assert blind.any() and torch.all(qkv[0].grad[blind] == 0)
    # the BSHD layout differentiates to the same gradients
    qkv_s = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*qkv_s, causal=True, window=8,
                        layout="BSHD").backward(dout.transpose(1, 2))
    for t, s in zip(qkv, qkv_s):
        torch.testing.assert_close(s.grad.transpose(1, 2), t.grad)
