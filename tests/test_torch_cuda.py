"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Every test here needs a GPU and nvcc and skips without them; run
them on the card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)

pytestmark = pytest.mark.cuda

# fp32: 2e-5 (no TF32 anywhere; sums in another order); bf16: 2e-2 (the
# kernel rounds P to bf16 before PV, the plain version does not)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make(dev, dtype, B, Hkv, C, r, dh, page, maxp, starts, nvalid, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    slots = B * Hkv * maxp + 3
    tables = torch.randperm(slots, generator=g, device=dev)[:B * Hkv * maxp]
    starts = torch.tensor(starts, dtype=torch.int32, device=dev)
    nvalid = torch.tensor(nvalid, dtype=torch.int32, device=dev)
    lengths = torch.where(nvalid > 0, starts + nvalid, 0).to(torch.int32)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return (rnd(B, Hkv, C, r, dh), rnd(slots, page, dh), rnd(slots, page, dh),
            tables.reshape(B, Hkv, maxp).to(torch.int32), lengths, starts)


SHAPES = [
    # decode rows, GQA r = 5 (qwen3), dh 128
    dict(B=4, Hkv=8, C=1, r=5, dh=128, page=16, maxp=8,
         starts=[0, 17, 60, 127], nvalid=[1, 1, 1, 1]),
    # MHA decode (C * r == 1), dh 96 (a masked tile)
    dict(B=3, Hkv=4, C=1, r=1, dh=96, page=16, maxp=4,
         starts=[5, 31, 63], nvalid=[1, 1, 1]),
    # prefill chunks crossing pages, a padded row, dh 64, page 8
    dict(B=3, Hkv=2, C=16, r=4, dh=64, page=8, maxp=8,
         starts=[0, 13, 0], nvalid=[16, 9, 0]),
    # mixed decode + prefill rows at the slice's widths
    dict(B=4, Hkv=8, C=64, r=5, dh=128, page=16, maxp=16,
         starts=[200, 0, 64, 0], nvalid=[1, 64, 37, 0]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_kernel_matches_plain(cuda, shape, dtype):
    args = make(cuda, dtype, **SHAPES[shape])
    before = ops.LAUNCHES["paged_prefill_attention"]
    got = ops.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_prefill_attention"] == before + 1
    q, k, v, tables, lengths, starts = args
    ref = paged_prefill_attention_ref(q, k, v, tables, lengths, starts)
    err = (got.float() - ref.float()).abs()
    assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
        err.max().item()
    padded = (lengths == 0).nonzero().flatten().tolist()
    for b in padded:
        assert torch.all(got[b] == 0)


def test_kernel_reads_a_layer_view_in_place(cuda):
    """A layer of an (L, slots, page, dh) pool is taken as the view
    ``pool[idx]`` — its pointer offset — and gives the same result as a
    standalone copy."""
    q, k, v, tables, lengths, starts = make(cuda, torch.bfloat16,
                                            **SHAPES[0])
    kp = torch.stack([torch.zeros_like(k), k, torch.zeros_like(k)])
    vp = torch.stack([torch.zeros_like(v), v, torch.zeros_like(v)])
    got = ops.paged_prefill_attention(q, kp[1], vp[1], tables, lengths,
                                      starts)
    want = ops.paged_prefill_attention(q, k.clone(), v.clone(), tables,
                                       lengths, starts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_out_of_range_tables_clipped(cuda):
    q, k, v, tables, lengths, starts = make(cuda, torch.float32, **SHAPES[2])
    bad = tables.clone()
    bad[:, :, 6:] = -3                       # past every row's length
    bad[0, :, 5:] = 10 ** 6
    got = ops.paged_prefill_attention(q, k, v, bad, lengths, starts)
    want = paged_prefill_attention_ref(q, k, v, bad.clamp(0, k.shape[0] - 1),
                                       lengths, starts)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 2e-5 * (1 + want.abs())).all()


def test_lengths_past_the_table_read_only_the_table(cuda):
    """A length past max_pages * page sees only the keys the table holds,
    as the reference's page grid does: both kernels read nothing past a
    table row."""
    q, k, v, tables, lengths, starts = make(cuda, torch.float32, **SHAPES[2])
    long = torch.full_like(lengths, 10 ** 6)
    got = ops.paged_prefill_attention(q, k, v, tables, long, starts + 10 ** 5)
    want = paged_prefill_attention_ref(q, k, v, tables, long,
                                       starts + 10 ** 5)
    qd, kd, vd, td, ld = make_decode(cuda, torch.float32, **DECODE_SHAPES[1])
    gotd = ops.paged_attention(qd, kd, vd, td, torch.full_like(ld, 10 ** 6))
    wantd = paged_attention_ref(qd, kd, vd, td, torch.full_like(ld, 10 ** 6))
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 2e-5 * (1 + want.abs())).all()
    assert ((gotd - wantd).abs() <= 2e-5 * (1 + wantd.abs())).all()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, tables, lengths, starts = make(cuda, torch.float32,
                                            B=1, Hkv=1, C=1, r=1, dh=32,
                                            page=16, maxp=2, starts=[3],
                                            nvalid=[1])
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_prefill_attention(q, k, v, tables, lengths, starts)
    q, k, v, tables, lengths, starts = make(cuda, torch.float32, **SHAPES[0])
    with pytest.raises(TypeError, match="dtype"):
        ops.paged_prefill_attention(q, k.to(torch.bfloat16), v, tables,
                                    lengths, starts)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.paged_prefill_attention(q, k, v, tables, lengths.cpu(), starts)


# decode kernel: (B, Hkv, r, dh, page, maxp, lengths) — qwen3-14b's GQA
# r = 5 with ragged contexts to 2048 and padded rows, MHA r = 1 at dh 64,
# r = 7 at dh 96 (a masked tile), contexts on and off span boundaries
DECODE_SHAPES = [
    dict(Hkv=8, r=5, dh=128, page=16, maxp=128,
         lengths=[2048, 1, 0, 129, 1000, 127, 128, 0]),
    dict(Hkv=4, r=1, dh=64, page=16, maxp=8, lengths=[5, 128, 0, 97]),
    dict(Hkv=2, r=7, dh=96, page=16, maxp=16, lengths=[256, 17, 255]),
]


def make_decode(dev, dtype, Hkv, r, dh, page, maxp, lengths, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    slots = B * Hkv * maxp + 3
    tables = torch.randperm(slots, generator=g, device=dev)[:B * Hkv * maxp]
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return (rnd(B, Hkv, r, dh), rnd(slots, page, dh), rnd(slots, page, dh),
            tables.reshape(B, Hkv, maxp).to(torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(DECODE_SHAPES)))
def test_decode_kernel_matches_plain(cuda, shape, dtype):
    args = make_decode(cuda, dtype, **DECODE_SHAPES[shape])
    before = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == before + 1
    ref = paged_attention_ref(*args)
    err = (got.float() - ref.float()).abs()
    assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
        err.max().item()
    for b in (args[4] == 0).nonzero().flatten().tolist():
        assert torch.all(got[b] == 0)


def test_decode_kernel_clips_tables_and_reads_a_layer_view(cuda):
    q, k, v, tables, lengths = make_decode(cuda, torch.float32,
                                           **DECODE_SHAPES[1])
    bad = tables.clone()
    bad[:, :, 7:] = -3                       # past every row's length
    bad[0, :, 1:] = 10 ** 6
    kp = torch.stack([torch.zeros_like(k), k])
    vp = torch.stack([torch.zeros_like(v), v])
    got = ops.paged_attention(q, kp[1], vp[1], bad, lengths)
    want = paged_attention_ref(q, k, v, bad.clamp(0, k.shape[0] - 1),
                               lengths)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 2e-5 * (1 + want.abs())).all()


def test_decode_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, tables, lengths = make_decode(cuda, torch.float32,
                                           **DECODE_SHAPES[1])
    with pytest.raises(TypeError, match="dtype"):
        ops.paged_attention(q, k.to(torch.bfloat16), v, tables, lengths)
    with pytest.raises(ValueError, match="at most"):
        ops.paged_attention(q.expand(-1, -1, 17, -1), k, v, tables, lengths)


# dense flash attention: (B, Hq, Hkv, Sq, Sk, dh, causal, window) — the
# reference's kernel test cases at the head dims the kernel takes, S not a
# multiple of the 64-query / 32-key tiles, qwen3-14b's r = 5 at dh 128,
# and keys shorter than the queries so windowed rows see no key
FLASH_SHAPES = [
    (1, 4, 4, 128, 128, 64, True, 0),        # MHA
    (2, 8, 2, 256, 256, 64, True, 0),        # GQA r = 4
    (1, 4, 1, 128, 128, 128, True, 0),       # MQA
    (2, 4, 2, 192, 192, 96, True, 0),        # dh 96
    (1, 10, 2, 100, 100, 128, True, 0),      # r = 5, S = 100
    (1, 2, 2, 100, 100, 64, False, 0),       # non-causal, S = 100
    (1, 4, 2, 128, 128, 64, True, 16),       # sliding windows
    (1, 4, 2, 200, 200, 96, True, 48),
    (1, 4, 2, 128, 128, 128, False, 96),
    (1, 4, 2, 130, 70, 64, True, 16),        # rows past kv + window: 0
]


def make_flash(dev, dtype, B, Hq, Hkv, Sq, Sk, dh, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return rnd(B, Hq, Sq, dh), rnd(B, Hkv, Sk, dh), rnd(B, Hkv, Sk, dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(FLASH_SHAPES)))
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    B, Hq, Hkv, Sq, Sk, dh, causal, window = FLASH_SHAPES[shape]
    q, k, v = make_flash(cuda, dtype, B, Hq, Hkv, Sq, Sk, dh)
    before = fa_ops.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    err = (got.float() - ref.float()).abs()
    assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
        err.max().item()
    blind = (ref == 0).all(-1)               # rows that see no key
    assert torch.all(got[blind] == 0)
    if Sq > Sk + window > window > 0:
        assert blind.any()


def test_flash_kernel_bshd_views_and_strides(cuda):
    """The model's (B, S, H, dh) layout and a K/V that are strided views
    of one fused projection give what contiguous BHSD copies give."""
    q, k, v = make_flash(cuda, torch.bfloat16, 2, 10, 2, 150, 150, 128)
    qs = q.transpose(1, 2).contiguous()
    kv = torch.cat([k.transpose(1, 2), v.transpose(1, 2)], dim=2)
    got = fa_ops.flash_attention(qs, kv[:, :, :2], kv[:, :, 2:],
                                 causal=True, layout="BSHD")
    want = fa_ops.flash_attention(q, k.contiguous(), v.contiguous(),
                                  causal=True)
    torch.cuda.synchronize()
    assert got.shape == qs.shape
    assert torch.equal(got.transpose(1, 2), want)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = make_flash(cuda, torch.float32, 1, 4, 2, 64, 64, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, k, v)
    q, k, v = make_flash(cuda, torch.float32, 1, 4, 2, 64, 64, 64)
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q, k.transpose(2, 3), v)
