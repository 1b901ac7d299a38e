"""The design of B3's backward (``csrc/flash_attention_bwd.cu``), held on
the CPU.

``emulate_backward`` repeats the three kernels' decomposition in plain
PyTorch: D = rowsum(dO * O); the dK/dV pass over blocks of 64 keys of one
(batch, kv head), each walking only the tiles of folded query rows
(position * r + head-in-group; 64 rows, 32 at dh 128) that can see one of
its keys, P recomputed from the forward's log-sum-exp in log2 units, dV
+= P^T dO, dS = P * (dP - D), dK += dS^T Q * scale; the dQ pass over
tiles of 64 folded rows, walking the key tiles (64 keys, 32 in fp32)
that its rows see, dQ += dS K * scale.  In bf16 P and dS are rounded to
bf16 before their products, as the kernels' A operands are.  Every tile
the kernels skip is checked to hold no visible (row, key) pair.  Held
against autograd of the plain version (``flash_attention_ref``) on
inputs made with numpy from a seed: fp32 2e-5 and bf16 2e-2 of each
gradient's largest magnitude."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
KEYS_PER_BLOCK = 64                         # dK/dV: 16 keys a warp, 4 warps
ROWS_PER_BLOCK = 64                         # dQ: 16 rows a warp, 4 warps


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


def emulate_backward(q, k, v, out, lse, dout, *, causal, window):
    """(dq, dk, dv) as the three kernels compute them, in fp32."""
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
# window (rows that see no key); Sq < Sk
CASES = {
    "mha_dh64": (1, 2, 2, 200, 200, 64, True, 0),
    "gqa_r5": (1, 10, 2, 70, 70, 64, True, 0),
    "gqa_dh128": (2, 4, 2, 100, 100, 128, True, 0),
    "noncausal_dh80": (1, 2, 2, 150, 150, 80, False, 0),
    "window_dh96": (1, 3, 1, 260, 260, 96, True, 40),
    "blind_rows": (1, 10, 2, 120, 50, 64, True, 16),
    "sq_lt_sk": (1, 4, 2, 40, 130, 64, True, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_emulation_matches_plain_autograd(name, dtype):
    B, Hq, Hkv, Sq, Sk, dh, causal, window = CASES[name]
    q, k, v, dout = inputs([(B, Hq, Sq, dh), (B, Hkv, Sk, dh),
                            (B, Hkv, Sk, dh), (B, Hq, Sq, dh)], dtype,
                           sorted(CASES).index(name))
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
