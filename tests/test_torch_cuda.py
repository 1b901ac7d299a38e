"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Every test here needs a GPU and nvcc and skips without them; run
them on the card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)
from repro_torch.telemetry import MetricsRegistry

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
    # nvalid 0 pads a row (lengths 0); a negative one puts lengths below
    # starts
    lengths = torch.where(nvalid != 0, starts + nvalid, 0).to(torch.int32)
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


# the edges of the tensor-core design: a 2048-key decode context that is
# split into spans, the same context as a 1-token row of a 64-token mixed
# bucket, M = C * r not a multiple of 16 (one split tile of 15 rows, and 65
# rows), MHA at dh 96, page 8 with 64-key tiles crossing pages, and rows
# whose chunk starts at or past their length
EDGE_SHAPES = {
    "decode_2048_split": dict(B=3, Hkv=8, C=1, r=5, dh=128, page=16,
                              maxp=128, starts=[2047, 1000, 63],
                              nvalid=[1, 1, 1]),
    "mixed_2048": dict(B=4, Hkv=8, C=64, r=5, dh=128, page=16, maxp=128,
                       starts=[2047, 0, 1500, 0], nvalid=[1, 64, 30, 0]),
    "r5_c3_split": dict(B=3, Hkv=2, C=3, r=5, dh=128, page=16, maxp=24,
                        starts=[126, 0, 300], nvalid=[3, 2, 3]),
    "r5_c13": dict(B=2, Hkv=2, C=13, r=5, dh=128, page=16, maxp=16,
                   starts=[0, 190], nvalid=[13, 13]),
    "mha_dh96_c64": dict(B=2, Hkv=4, C=64, r=1, dh=96, page=16, maxp=16,
                         starts=[0, 130], nvalid=[64, 50]),
    "page8_crossing": dict(B=2, Hkv=2, C=16, r=4, dh=64, page=8, maxp=40,
                           starts=[290, 5], nvalid=[16, 11]),
    "starts_past_lengths": dict(B=3, Hkv=2, C=8, r=5, dh=64, page=16,
                                maxp=8, starts=[50, 100, 20],
                                nvalid=[-30, -1, 8]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(EDGE_SHAPES))
def test_kernel_design_edges_match_plain(cuda, name, dtype):
    shape = EDGE_SHAPES[name]
    args = make(cuda, dtype, **shape)
    q, k, v, tables, lengths, starts = args
    n_splits, _ = ops.split_plan(shape["B"], shape["Hkv"], shape["C"],
                                 shape["r"], shape["maxp"], shape["page"])
    assert (n_splits > 1) == name.endswith("_split")
    got = ops.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    ref = paged_prefill_attention_ref(*args)
    err = (got.float() - ref.float()).abs()
    assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
        err.max().item()
    for b in (lengths == 0).nonzero().flatten().tolist():
        assert torch.all(got[b] == 0)


def test_kernel_reads_q_by_its_strides(cuda):
    """The transposed view the model passes ((B, C, Hkv, r, dh) memory)
    gives exactly what a contiguous q gives, and the result is laid out
    so that transposing it back to (B, C, Hkv, r, dh) is contiguous."""
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (EDGE_SHAPES["mixed_2048"], EDGE_SHAPES["r5_c3_split"]):
            q, k, v, tables, lengths, starts = make(cuda, dtype, **shape)
            qv = q.transpose(1, 2).contiguous().transpose(1, 2)
            assert not qv.is_contiguous()
            got = ops.paged_prefill_attention(qv, k, v, tables, lengths,
                                              starts)
            want = ops.paged_prefill_attention(q, k, v, tables, lengths,
                                               starts)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert got.shape == q.shape
            assert got.transpose(1, 2).is_contiguous()


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


# B1's wgmma path (bf16, C * r > 16, a page in ops.WGMMA_PAGES) at each
# head dim: the mixed row mix of a fused step (decode rows in the 64-token
# bucket, a full and a partial chunk, padded rows), at r = 5 (320 rows: two
# blocks of three consumer groups, two at dh 96), r = 6 (384: whole
# blocks), r = 1 (64 rows: one group a kv head, two heads a block) and
# r = 2 at C = 40 (80 rows: a block with an empty group); pages of 8 and
# 32 keys; an odd number of kv heads at 64 rows or fewer.  On an H100 these
# small grids take two-group blocks at dh 64 and 128 (three would leave SMs
# idle); the wide cases take three
WGMMA_SHAPES = {
    **{f"mixed_dh{dh}_r{r}": dict(B=5, Hkv=2, C=64, r=r, dh=dh, page=16,
                                  maxp=48, starts=[700, 0, 130, 0, 64],
                                  nvalid=[1, 64, 30, 0, 1])
       for dh in ops.HEAD_DIMS for r in (1, 5)},
    "mixed_dh128_r6": dict(B=3, Hkv=2, C=64, r=6, dh=128, page=16, maxp=40,
                           starts=[600, 17, 0], nvalid=[1, 64, 0]),
    "r2_c40_page8": dict(B=3, Hkv=3, C=40, r=2, dh=64, page=8, maxp=64,
                         starts=[300, 5, 0], nvalid=[1, 40, 0]),
    "page32_dh96": dict(B=2, Hkv=2, C=64, r=1, dh=96, page=32, maxp=24,
                        starts=[500, 33], nvalid=[1, 64]),
    # 48 rows, three kv heads: two heads a block, the last block one
    "mha_hkv3_dh128": dict(B=3, Hkv=3, C=48, r=1, dh=128, page=16, maxp=32,
                           starts=[400, 0, 0], nvalid=[1, 48, 0]),
    # two heads a block at dh 96 (32-column atoms) and page 8: 48 boxes a
    # tile, issued in two rounds
    "mha_page8_dh96": dict(B=3, Hkv=3, C=48, r=1, dh=96, page=8, maxp=64,
                           starts=[300, 0, 0], nvalid=[1, 48, 0]),
    # a table of 720 keys (not whole 64-key tiles), a row reaching its
    # last tile: the producer's boxes for pages 45-47 lie past the table
    "past_table_dh64": dict(B=2, Hkv=2, C=64, r=5, dh=64, page=16, maxp=45,
                            starts=[710, 0], nvalid=[1, 64]),
    # enough (row, kv head)s that three groups a block fill an H100's 132
    # SMs (the cases above take two-group blocks there)
    **{f"wide_dh{dh}_r5": dict(B=17, Hkv=4, C=64, r=5, dh=dh, page=16,
                               maxp=32, starts=[300 + 7 * i for i in range(16)]
                               + [0], nvalid=[1] * 15 + [64, 0])
       for dh in (64, 128)},
}


def wgmma_case(dev, name, seed=0):
    shape = WGMMA_SHAPES[name]
    args = make(dev, torch.bfloat16, seed=seed, **shape)
    assert ops.prefill_tile(torch.bfloat16, shape["C"], shape["r"],
                            shape["page"]) == "wgmma"
    return args


def assert_close_to_plain(got, args, tables=None):
    q, k, v, tb, lengths, starts = args
    tb = tb if tables is None else tables
    ref = paged_prefill_attention_ref(q, k, v, tb, lengths, starts)
    err = (got.float() - ref.float()).abs()
    assert (err <= 2e-2 * (1 + ref.float().abs())).all(), err.max().item()
    assert torch.isfinite(got).all()
    for b in (lengths == 0).nonzero().flatten().tolist():
        assert torch.all(got[b] == 0)            # padded rows exactly 0


@pytest.mark.parametrize("name", sorted(WGMMA_SHAPES))
def test_wgmma_path_matches_plain(cuda, name):
    """The TMA-fed wgmma kernel against the plain version, with q as the
    model's transposed view too (bit-equal to a contiguous q), and two
    launches bit-equal."""
    args = wgmma_case(cuda, name)
    before = ops.LAUNCHES["paged_prefill_attention"]
    got = ops.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_prefill_attention"] == before + 1
    assert_close_to_plain(got, args)
    q = args[0]
    qv = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qv.is_contiguous()
    again = ops.paged_prefill_attention(qv, *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("name", ["mixed_dh128_r5", "mixed_dh96_r1",
                                  "r2_c40_page8"])
def test_wgmma_path_clamps_tables_and_lengths(cuda, name):
    """Table entries out of the pool are clamped into it, pages past the
    table row count for nothing, and a length past the table sees only
    the table's keys, as the plain version over clamped tables."""
    q, k, v, tables, lengths, starts = wgmma_case(cuda, name, seed=3)
    bad = tables.clone()
    n_pages = tables.shape[-1]
    bad[:, :, n_pages // 2:] = -3
    bad[0, :, n_pages // 3:] = 10 ** 6
    got = ops.paged_prefill_attention(q, k, v, bad, lengths, starts)
    torch.cuda.synchronize()
    assert_close_to_plain(got, (q, k, v, tables, lengths, starts),
                          tables=bad.clamp(0, k.shape[0] - 1))
    long = torch.where(lengths > 0, 10 ** 6, 0).to(torch.int32)
    late = torch.where(lengths > 0, starts + 10 ** 5, starts).to(torch.int32)
    got = ops.paged_prefill_attention(q, k, v, tables, long, late)
    torch.cuda.synchronize()
    assert_close_to_plain(got, (q, k, v, tables, long, late))


@pytest.mark.parametrize("page", [4, 128])
def test_other_pages_take_the_shared_tile(cuda, page):
    """A page the wgmma path's boxes do not take goes, by the shape
    dispatch, to the shared tile, which reads any page size."""
    shape = dict(WGMMA_SHAPES["mixed_dh128_r5"], page=page,
                 maxp=2048 // page)
    assert ops.prefill_tile(torch.bfloat16, shape["C"], shape["r"],
                            page) == "shared"
    args = make(cuda, torch.bfloat16, **shape)
    got = ops.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert_close_to_plain(got, args)


# every prefill tile: the wgmma path (three groups and two heads a block,
# pages past the table), the shared tile at page 4, the decode tile
# (decode rows, and three chunk tokens at r = 5), the one-warp split tile
# at page 4, and fp32
POISON_CASES = {
    **{name: (torch.bfloat16, WGMMA_SHAPES[name])
       for name in ("mixed_dh128_r5", "mixed_dh96_r1", "mixed_dh96_r5",
                    "r2_c40_page8", "past_table_dh64")},
    "shared_page4": (torch.bfloat16, dict(WGMMA_SHAPES["mixed_dh128_r5"],
                                          page=4, maxp=512)),
    "split_decode": (torch.bfloat16, SHAPES[0]),
    "tma_c3_r5": (torch.bfloat16, EDGE_SHAPES["r5_c3_split"]),
    "warp_page4_decode": (torch.bfloat16, dict(SHAPES[0], page=4, maxp=32)),
    "fp32_mixed": (torch.float32, SHAPES[3]),
}


def poisoned(args):
    """args with NaN in every pool row past each row's length (the last
    page's tail, the table row's later pages, a padded row's pages) and in
    the slots no table names."""
    q, k, v, tables, lengths, starts = args
    k, v = k.clone(), v.clone()
    slots, page, _ = k.shape
    maxp = tables.shape[-1]
    pos = torch.arange(maxp * page, device=k.device)
    slot = tables.long()[..., pos // page]                   # (B, Hkv, S)
    row = (pos % page).expand_as(slot)
    past = (pos >= lengths.long().clamp(0, maxp * page)[:, None, None]
            ).expand_as(slot)
    k[slot[past], row[past]] = float("nan")
    v[slot[past], row[past]] = float("nan")
    named = torch.zeros(slots, dtype=torch.bool, device=k.device)
    named[tables.long().flatten()] = True
    k[~named] = float("nan")
    v[~named] = float("nan")
    return q, k, v, tables, lengths, starts


@pytest.mark.parametrize("name", sorted(POISON_CASES))
def test_pool_contents_past_the_lengths_do_not_reach_the_output(cuda, name):
    """Whatever the pools hold past each row's length, non-finite values
    too, the output is the plain version's on finite pools.  The table
    names no slot 0, so that the wgmma producer's slot for pages past the
    table row holds NaN too."""
    dtype, shape = POISON_CASES[name]
    q, k, v, tables, lengths, starts = make(cuda, dtype, seed=5, **shape)
    named = torch.zeros(k.shape[0], dtype=torch.bool, device=cuda)
    named[tables.long().flatten()] = True
    tables = torch.where(tables == 0, (~named).nonzero()[0, 0].to(
        torch.int32), tables)
    clean = (q, k, v, tables, lengths, starts)
    got = ops.paged_prefill_attention(*poisoned(clean))
    torch.cuda.synchronize()
    ref = paged_prefill_attention_ref(*clean)
    err = (got.float() - ref.float()).abs()
    assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
        err.max().item()
    assert torch.isfinite(got).all()


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


# the decode kernel's tensor-core split tiles: out-of-range table entries
# past each length (clamped in the kernel: the wrapper no longer clamps),
# MHA r = 1 at dh 96 over split spans, r = 16 (a full m16 tile), every row
# padded, and a batch large enough that the plan does not split
DECODE_EDGES = {
    "bad_tables_bf16": dict(Hkv=8, r=5, dh=128, page=16, maxp=64,
                            lengths=[1000, 1, 17, 640], bad=True),
    "mha_r1_dh96": dict(Hkv=4, r=1, dh=96, page=16, maxp=32,
                        lengths=[512, 0, 3, 300]),
    "r16": dict(Hkv=2, r=16, dh=128, page=16, maxp=16,
                lengths=[256, 100, 1]),
    "all_padded": dict(Hkv=8, r=5, dh=64, page=16, maxp=8,
                       lengths=[0, 0, 0]),
    "unsplit": dict(Hkv=8, r=5, dh=128, page=16, maxp=4,
                    lengths=[64, 1, 33] * 48),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(DECODE_EDGES))
def test_decode_kernel_edges_match_plain(cuda, name, dtype):
    shape = dict(DECODE_EDGES[name])
    bad = shape.pop("bad", False)
    q, k, v, tables, lengths = make_decode(cuda, dtype, **shape)
    if bad:
        past = torch.arange(shape["maxp"], device=cuda)[None, None] \
            >= ((lengths + shape["page"] - 1) // shape["page"])[:, None, None]
        tables = torch.where(past, torch.where(
            torch.rand(tables.shape, device=cuda) < 0.5, -7,
            k.shape[0] + 5), tables).to(torch.int32)
    tile = ops.decode_tile(dtype, shape["page"], shape["r"])
    # the decode tile in bf16 where a kv head has r > 1 query rows
    assert tile == ("tma" if dtype == torch.bfloat16 and shape["r"] > 1
                    else "warp")
    if tile == "warp":                           # the split plan's spans
        n_splits, _ = ops.split_plan(len(shape["lengths"]), shape["Hkv"], 1,
                                     shape["r"], shape["maxp"],
                                     shape["page"])
        assert (n_splits == 1) == (name == "unsplit")
    got = ops.paged_attention(q, k, v, tables, lengths)
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, k, v, tables.clamp(0, k.shape[0] - 1),
                              lengths)
    err = (got.float() - ref.float()).abs()
    assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
        err.max().item()
    for b in (lengths == 0).nonzero().flatten().tolist():
        assert torch.all(got[b] == 0)


def test_decode_pool_contents_past_the_lengths_do_not_reach_the_output(
        cuda):
    """B2 on the decode tile (and on the split tile at r = 1 and at page
    4): NaN in every pool row past each row's length and in every slot no
    table names leaves the output the plain version's on finite pools."""
    for shape in (DECODE_SHAPES[0], DECODE_EDGES["mha_r1_dh96"],
                  dict(DECODE_SHAPES[2], page=4, maxp=64)):
        shape = dict(shape)
        q, k, v, tables, lengths = make_decode(cuda, torch.bfloat16,
                                               seed=5, **shape)
        named = torch.zeros(k.shape[0], dtype=torch.bool, device=cuda)
        named[tables.long().flatten()] = True
        tables = torch.where(tables == 0, (~named).nonzero()[0, 0].to(
            torch.int32), tables)
        starts = torch.zeros_like(lengths)
        _, kp, vp, *_ = poisoned((q[:, :, None], k, v, tables, lengths,
                                  starts))
        got = ops.paged_attention(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        ref = paged_attention_ref(q, k, v, tables, lengths)
        err = (got.float() - ref.float()).abs()
        assert (err <= 2e-2 * (1 + ref.float().abs())).all(), \
            err.max().item()
        assert torch.isfinite(got).all()
        assert torch.all(got[lengths == 0] == 0)
        # the plain version on the same poisoned pools: V cleared past
        # each length there too, so it is its finite pools' output
        ref_p = paged_attention_ref(q, kp, vp, tables, lengths)
        assert torch.isfinite(ref_p).all() and torch.equal(ref_p, ref)
        err = (got.float() - ref_p.float()).abs()
        assert (err <= 2e-2 * (1 + ref_p.float().abs())).all(), \
            err.max().item()


# the decode tile's work split at the edges of its grid: one long row
# crossing dozens of blocks, many rows whose (row, kv head)s share blocks,
# fewer tiles than blocks, every row padded, and a batch of 160 rows (the
# split scan's rows past 32 at a time)
TMA_GRIDS = {
    "one_long_row": dict(Hkv=1, r=5, dh=128, page=16, maxp=512,
                         lengths=[8000]),
    "many_short_rows": dict(Hkv=8, r=5, dh=128, page=16, maxp=8,
                            lengths=[1, 17, 64, 65, 100, 128] * 11),
    "fewer_tiles_than_blocks": dict(Hkv=2, r=3, dh=64, page=8, maxp=4,
                                    lengths=[10, 0, 32]),
    "all_padded": dict(Hkv=4, r=5, dh=96, page=32, maxp=4,
                       lengths=[0, 0]),
    "wide_batch": dict(Hkv=2, r=2, dh=64, page=64, maxp=8,
                       lengths=[(37 * i) % 500 for i in range(160)]),
}


@pytest.mark.parametrize("name", sorted(TMA_GRIDS))
def test_decode_tile_grid_edges_match_plain(cuda, name):
    """B2 and B1's C = 1 launches of the decode tile at the grid's edges,
    each against the plain version, padded rows exactly 0, and the
    tickets every launch leaves at 0."""
    shape = TMA_GRIDS[name]
    q, k, v, tables, lengths = make_decode(cuda, torch.bfloat16, **shape)
    got = ops.paged_attention(q, k, v, tables, lengths)
    chunk = ops.paged_prefill_attention(q[:, :, None], k, v, tables,
                                        lengths, (lengths - 1).clamp(min=0))
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, k, v, tables, lengths)
    for out in (got, chunk[:, :, 0]):
        err = (out.float() - ref.float()).abs()
        assert (err <= 2e-2 * (1 + ref.float().abs())).all(), \
            err.max().item()
        assert torch.all(out[lengths == 0] == 0)
    assert all(int(t.abs().sum()) == 0 for t in ops._TICKETS.values())


def test_decode_tile_repeats_bit_for_bit(cuda):
    """The merge runs in span order whichever block finishes last, so
    launches repeat bit for bit (B2, and B1 at C * r <= 16)."""
    q, k, v, tables, lengths = make_decode(cuda, torch.bfloat16,
                                           **DECODE_SHAPES[0])
    first = ops.paged_attention(q, k, v, tables, lengths)
    args = make(cuda, torch.bfloat16, **EDGE_SHAPES["r5_c3_split"])
    chunk = ops.paged_prefill_attention(*args)
    for _ in range(5):
        assert torch.equal(ops.paged_attention(q, k, v, tables, lengths),
                           first)
        assert torch.equal(ops.paged_prefill_attention(*args), chunk)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype, page, r, tile", [
    (torch.bfloat16, 16, 5, "tma"), (torch.bfloat16, 8, 5, "tma"),
    (torch.float32, 16, 5, "warp"), (torch.bfloat16, 4, 5, "warp"),
    (torch.bfloat16, 16, 1, "warp")])
def test_the_decode_kernel_is_chosen_by_dtype_and_page(cuda, dtype, page,
                                                        r, tile):
    """bf16 at a page in WGMMA_PAGES with r > 1 query rows a kv head takes
    the decode tile; fp32, page 4 and MHA (r = 1) the one-warp split tile,
    for B2 and for B1's decode rows alike (B1 counts the launch under its
    tile)."""
    assert ops.decode_tile(dtype, page, r) == tile
    assert ops.launch_tile(dtype, 1, r, page) == tile
    shape = dict(DECODE_SHAPES[0], page=page, maxp=2048 // page, r=r)
    q, k, v, tables, lengths = make_decode(cuda, dtype, **shape)
    before = dict(ops.PREFILL_TILE_LAUNCHES)
    got = ops.paged_attention(q, k, v, tables, lengths)
    chunk = ops.paged_prefill_attention(q[:, :, None], k, v, tables,
                                        lengths, (lengths - 1).clamp(min=0))
    torch.cuda.synchronize()
    assert ops.PREFILL_TILE_LAUNCHES[tile] == before[tile] + 1
    ref = paged_attention_ref(q, k, v, tables, lengths)
    for out in (got, chunk[:, :, 0]):
        err = (out.float() - ref.float()).abs()
        assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
            err.max().item()


def test_decode_kernel_reads_q_by_its_strides(cuda):
    """q as the transposed view of a (B, r, Hkv, dh) tensor and as a slice
    of a wider one gives exactly what a contiguous q gives (no copy)."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tables, lengths = make_decode(cuda, dtype,
                                               **DECODE_SHAPES[0])
        views = (q.transpose(1, 2).contiguous().transpose(1, 2),
                 torch.cat([q, q], dim=-1)[..., :q.shape[-1]])
        want = ops.paged_attention(q, k, v, tables, lengths)
        for qv in views:
            assert not qv.is_contiguous()
            got = ops.paged_attention(qv, k, v, tables, lengths)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


# dense flash attention: (B, Hq, Hkv, Sq, Sk, dh, causal, window) — the
# reference's kernel test cases at the head dims the kernel takes, S not a
# multiple of the 64-row / 64-key tiles, qwen3-14b's r = 5 at dh 128,
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
    # the folded-row tiles: the r = 5 rows of a position straddle 64-row
    # tiles (S = 100, 150, 1000), 64 / 65 / 128 / 129 folded rows (r = 1)
    # on both sides of a tile edge, and keys shorter than the queries at
    # r = 5
    (1, 10, 2, 100, 100, 64, True, 0),
    (1, 10, 2, 150, 150, 96, True, 0),
    (1, 40, 8, 1000, 1000, 128, True, 0),
    (2, 10, 2, 150, 150, 128, False, 0),
    (1, 10, 2, 1000, 1000, 96, True, 200),
    (1, 2, 2, 64, 64, 64, True, 0),
    (1, 2, 2, 65, 65, 128, True, 0),
    (1, 2, 2, 128, 128, 96, True, 0),
    (1, 2, 2, 129, 129, 128, False, 0),
    (1, 10, 2, 130, 70, 128, True, 16),
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


# the families' shapes: (B, Hq, Hkv, S, dh, dv, causal, window) — MLA's
# q/k 192 with v 128 (MHA), hubert's dh 80 non-causal at S not a tile
# multiple, hymba's 25 over 5 heads at dh 64 with a window that cuts
FAMILY_FLASH_SHAPES = [
    (1, 8, 8, 300, 192, 128, True, 0),
    (2, 8, 8, 130, 192, 128, False, 0),
    (2, 16, 16, 400, 80, 80, False, 0),
    (1, 4, 4, 100, 80, 80, True, 32),
    (1, 25, 5, 300, 64, 64, True, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(FAMILY_FLASH_SHAPES)))
def test_flash_kernel_at_family_shapes(cuda, shape, dtype):
    B, Hq, Hkv, S, dh, dv, causal, window = FAMILY_FLASH_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(shape)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = rnd(B, Hq, S, dh), rnd(B, Hkv, S, dh), rnd(B, Hkv, S, dv)
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.shape == ref.shape == (B, Hq, S, dv)
    err = (got.float() - ref.float()).abs()
    assert (err <= TOL[dtype] * (1 + ref.float().abs())).all(), \
        err.max().item()


def test_flash_wrapper_takes_only_its_head_dim_pairs(cuda):
    """(192, 128) is built; v padded or cut to another width is not."""
    q, k, v = make_flash(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 192)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, k, v[..., :96].contiguous())
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q[..., :128], k[..., :128].contiguous(), v)


# ------------------------------------------- B3's bf16 forward (wgmma)
# (B, Hq, Hkv, Sq, Sk, causal, window) at every built (dh, dv): GQA r = 5
# causal at S not a multiple of the key tile (interior, masked and skipped
# tiles; the last block's second group past the end), MHA with a window
# that crosses tiles, MHA non-causal, and Sq > Sk at r = 5
FWD_DESIGN_SHAPES = [
    (1, 10, 2, 300, 300, True, 0),
    (1, 4, 4, 300, 300, True, 160),
    (2, 4, 4, 200, 200, False, 0),
    (1, 10, 2, 200, 130, True, 0),
]


def plain_lse(q, k, causal, window):
    """logsumexp of each row's scaled, masked scores in fp32; -inf where a
    row sees no key."""
    Hq, Sq, dh = q.shape[1:]
    Hkv, Sk = k.shape[1:3]
    kr = k.float().repeat_interleave(Hq // Hkv, dim=1)
    s = q.float() @ kr.transpose(-1, -2) / dh ** 0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= qp - kp < window
    return torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)


@pytest.mark.parametrize("dims", fa_ops.HEAD_DIMS)
@pytest.mark.parametrize("shape", range(len(FWD_DESIGN_SHAPES)))
def test_flash_bf16_forward_design_edges(cuda, shape, dims):
    """Output within bf16 2e-2 of the plain version and lse within 1e-4 of
    the plain scores' logsumexp (fp32, summed in another order; exp2 on the
    special-function unit), rows that see no key 0 and -inf."""
    B, Hq, Hkv, Sq, Sk, causal, window = FWD_DESIGN_SHAPES[shape]
    dh, dv = dims
    g = torch.Generator(device=cuda).manual_seed(shape)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = rnd(B, Hq, Sq, dh), rnd(B, Hkv, Sk, dh), rnd(B, Hkv, Sk, dv)
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    err = (out.float() - ref.float()).abs()
    assert (err <= 2e-2 * (1 + ref.float().abs())).all(), err.max().item()
    want = plain_lse(q, k, causal, window)
    blind = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), blind)
    assert torch.all(lse[blind] == float("-inf"))
    assert torch.all(out[blind] == 0)
    torch.testing.assert_close(lse[~blind], want[~blind], rtol=1e-4,
                               atol=1e-4)


def test_flash_bf16_forward_reads_bshd_slices_of_one_qkv_tensor(cuda):
    """q, k and v as BSHD slices of one (B, S, 3, H, dh) tensor: the same
    bits as contiguous BHSD copies (the tiles depend on the shapes alone),
    within bf16 2e-2 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 260, 3, 4, 128, generator=g, device=cuda).to(
        torch.bfloat16)
    got = fa_ops.flash_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                 causal=True, layout="BSHD")
    q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    want = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got.transpose(1, 2), want)
    ref = flash_attention_ref(q, k, v, causal=True).float()
    assert ((want.float() - ref).abs() <= 2e-2 * (1 + ref.abs())).all()


def test_flash_bf16_forward_repeats_bit_for_bit(cuda):
    """Two launches on the same inputs give the same output and lse."""
    q, k, v = make_flash(cuda, torch.bfloat16, 2, 10, 2, 333, 333, 128)
    a = fa_ops.flash_attention_fwd(q, k, v, causal=True, window=100)
    b = fa_ops.flash_attention_fwd(q, k, v, causal=True, window=100)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------ B3's backward
# (B, Hq, Hkv, Sq, Sk, dh, causal, window): causal MHA over several key
# blocks at each built head dim, GQA r = 5, non-causal at S not a tile
# multiple, a window, rows that see no key (Sq > Sk + window), Sq < Sk
FLASH_BWD_SHAPES = [
    (2, 2, 2, 200, 200, 64, True, 0),
    (1, 10, 2, 130, 130, 128, True, 0),
    (1, 4, 4, 150, 150, 80, False, 0),
    (1, 3, 3, 260, 260, 96, True, 40),
    (1, 10, 2, 120, 50, 64, True, 16),
    (1, 4, 2, 40, 130, 64, True, 0),
]


def plain_grads(q, k, v, dout, causal, window):
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    o = flash_attention_ref(*qkv, causal=causal, window=window)
    return torch.autograd.grad(o, qkv, dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(FLASH_BWD_SHAPES)))
def test_flash_backward_matches_plain(cuda, shape, dtype):
    """dq, dk, dv through ``FlashAttention`` (one launch of each backward
    kernel) against autograd of the plain version: fp32 2e-5 and bf16 2e-2
    of each gradient's largest magnitude; rows that see no key get 0."""
    B, Hq, Hkv, Sq, Sk, dh, causal, window = FLASH_BWD_SHAPES[shape]
    q, k, v = make_flash(cuda, dtype, B, Hq, Hkv, Sq, Sk, dh, seed=shape)
    dout = make_flash(cuda, dtype, B, Hq, Hkv, Sq, Sk, dh, seed=99)[0]
    before = dict(fa_ops.LAUNCHES)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*qkv, causal=causal, window=window)
    assert out.grad_fn is not None
    out.backward(dout)
    torch.cuda.synchronize()
    assert {n: fa_ops.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, **{n: 1 for n in fa_ops.BWD_KERNELS}}
    want = plain_grads(q, k, v, dout, causal, window)
    for t, w in zip(qkv, want):
        err = float((t.grad.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert torch.isfinite(t.grad).all() and err <= TOL[dtype], err
    blind = (flash_attention_ref(q, k, v, causal=causal, window=window)
             == 0).all(-1)
    assert torch.all(qkv[0].grad[blind] == 0)
    if Sq > Sk + window > window > 0:
        assert blind.any()


# bf16 only, the wgmma kernels' own cases: MHA dh 64 at S 4096, where
# every tile class occurs (interior, the diagonal, skipped); dh 80 and
# dh 96, read through a second 64-column box whose columns past dh are
# zeros, GQA with a window edge inside tiles at dh 96
FLASH_BWD_BF16_SHAPES = [
    (1, 2, 2, 4096, 4096, 64, True, 0),
    (1, 4, 4, 300, 300, 80, True, 0),
    (1, 6, 2, 260, 260, 96, True, 100),
]


@pytest.mark.parametrize("shape", range(len(FLASH_BWD_BF16_SHAPES)))
def test_flash_backward_bf16_design_cases(cuda, shape):
    """dq, dk, dv of the bf16 backward against autograd of the plain
    version in fp32, within 2e-2 of each gradient's largest magnitude."""
    B, Hq, Hkv, Sq, Sk, dh, causal, window = FLASH_BWD_BF16_SHAPES[shape]
    q, k, v = make_flash(cuda, torch.bfloat16, B, Hq, Hkv, Sq, Sk, dh,
                         seed=shape)
    dout = make_flash(cuda, torch.bfloat16, B, Hq, Hkv, Sq, Sk, dh, 7)[0]
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    fa_ops.flash_attention(*qkv, causal=causal, window=window).backward(dout)
    torch.cuda.synchronize()
    want = plain_grads(*(t.float() for t in (q, k, v, dout)), causal, window)
    for t, w in zip(qkv, want):
        err = float((t.grad.float() - w).abs().max() / w.abs().max())
        assert torch.isfinite(t.grad).all() and err <= 2e-2, err


def test_flash_backward_reads_bshd_slices_of_one_qkv_tensor(cuda):
    """q, k and v as BSHD slices of one (B, S, 3, H, dh) tensor (bases 2 H
    dh bytes apart, the position stride 3 H dh): the tensor maps take the
    slices' own strides; gradients within bf16 2e-2 of the plain ones."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, H, dh = 2, 300, 4, 64
    x = torch.randn(B, S, 3, H, dh, generator=g, device=cuda)
    dout = torch.randn(B, S, H, dh, generator=g, device=cuda)
    qkv = x.to(torch.bfloat16).requires_grad_()
    fa_ops.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           causal=True, layout="BSHD").backward(
                               dout.to(torch.bfloat16))
    torch.cuda.synchronize()
    ref = qkv.detach().float().requires_grad_()
    flash_attention_ref(*(ref[:, :, i].transpose(1, 2) for i in range(3)),
                        causal=True).backward(
                            dout.to(torch.bfloat16).float().transpose(1, 2))
    for i in range(3):
        got, w = qkv.grad[:, :, i].float(), ref.grad[:, :, i]
        err = float((got - w).abs().max() / w.abs().max())
        assert torch.isfinite(got).all() and err <= 2e-2, (i, err)


def test_flash_backward_in_the_model_layout_and_repeatable(cuda):
    """BSHD views (the model's) give the BHSD gradients, and a second run
    repeats the first bit for bit (no atomics)."""
    q, k, v = make_flash(cuda, torch.bfloat16, 2, 10, 2, 150, 150, 64)
    dout = make_flash(cuda, torch.bfloat16, 2, 10, 2, 150, 150, 64, 5)[0]

    def grads(layout):
        ts = [t.transpose(1, 2) if layout == "BSHD" else t
              for t in (q, k, v, dout)]
        qkv = [t.detach().contiguous().requires_grad_() for t in ts[:3]]
        fa_ops.flash_attention(*qkv, causal=True, layout=layout).backward(
            ts[3].contiguous())
        return [t.grad.transpose(1, 2) if layout == "BSHD" else t.grad
                for t in qkv]
    a, b, c = grads("BHSD"), grads("BSHD"), grads("BHSD")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_flash_with_grad_never_returns_an_output_without_grad_fn(cuda):
    q, k, v = make_flash(cuda, torch.bfloat16, 1, 4, 2, 64, 64, 64)
    for layout in ("BHSD", "BSHD"):
        for which in range(3):
            ts = [t.clone() for t in (q, k, v)]
            ts[which].requires_grad_()
            assert fa_ops.flash_attention(
                *ts, layout=layout).grad_fn is not None
    with torch.no_grad():
        assert fa_ops.flash_attention(
            q.requires_grad_(), k, v).grad_fn is None


# (B, Hq, Hkv, Sq, Sk, causal, window) at MLA's widths, q/k 192 and v 128:
# causal MHA over several key blocks (dK/dV's three walks, dQ's key
# halves), GQA non-causal at S not a tile multiple, a window edge inside
# tiles
FLASH_BWD_MLA_SHAPES = [
    (1, 4, 4, 300, 300, True, 0),
    (2, 6, 2, 130, 130, False, 0),
    (1, 2, 2, 260, 260, True, 100),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(FLASH_BWD_MLA_SHAPES)))
def test_flash_backward_at_mla_widths_matches_plain(cuda, shape, dtype):
    """(192, 128): dq, dk, dv through ``FlashAttention`` (one launch of
    each backward kernel) against autograd of the plain version, fp32 2e-5
    and bf16 2e-2 of each gradient's largest magnitude (bf16 against the
    plain version in fp32)."""
    B, Hq, Hkv, Sq, Sk, causal, window = FLASH_BWD_MLA_SHAPES[shape]
    q, k, _ = make_flash(cuda, dtype, B, Hq, Hkv, Sq, Sk, 192, seed=shape)
    _, _, v = make_flash(cuda, dtype, B, Hq, Hkv, Sq, Sk, 128, seed=shape)
    dout = make_flash(cuda, dtype, B, Hq, Hkv, Sq, Sk, 128, seed=99)[0]
    before = dict(fa_ops.LAUNCHES)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*qkv, causal=causal, window=window)
    assert out.shape == (B, Hq, Sq, 128) and out.grad_fn is not None
    out.backward(dout)
    torch.cuda.synchronize()
    assert {n: fa_ops.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, **{n: 1 for n in fa_ops.BWD_KERNELS}}
    want = plain_grads(*(t.float() for t in (q, k, v, dout)), causal,
                       window)
    for t, w in zip(qkv, want):
        err = float((t.grad.float() - w).abs().max() / w.abs().max())
        assert torch.isfinite(t.grad).all() and err <= TOL[dtype], err


def test_flash_backward_refuses_unbuilt_widths(cuda):
    """A pair without a backward instance, (256, 256): a gradient request
    raises before anything runs, and never falls back to the plain
    version."""
    q, k, v = make_flash(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 256)
    before = dict(fa_ops.LAUNCHES)
    with pytest.raises(NotImplementedError, match="not built"):
        fa_ops.flash_attention(q.requires_grad_(), k, v)
    assert fa_ops.LAUNCHES == before


# ----------------------------------------------------------- MoE FFN
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_on_the_card_matches_the_cpu_without_syncing(cuda, shared):
    """``moe_apply`` on the card against the same call on the CPU in fp32
    (no TF32; sums in another order: 2e-5): a capped pass (T = 256 > 64)
    whose 48 identical tokens overload their experts, and 8 tokens of
    zeros whose tied router logits pick experts 0-3.  The call on the
    card never waits on the device from the host."""
    from repro_torch.models import mlp
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="moe", family="moe", n_layers=1, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=128,
                      n_experts=16, top_k=4, moe_d_ff=384,
                      n_shared_experts=shared, dtype="float32")
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g) / s[-2] ** 0.5
    p = {"router": rnd(d, E), "wi": rnd(E, d, ff), "wg": rnd(E, d, ff),
         "wo": rnd(E, ff, d)}
    if shared:
        p["shared"] = {"wi": rnd(d, ff), "wg": rnd(d, ff), "wo": rnd(ff, d)}
    x = torch.randn(8, 32, d, generator=g)
    x[2, :16] = x[1, :32] = x[0, 0]
    x[7, 24:] = 0.0
    want, want_aux = mlp.moe_apply(cfg, p, x)
    _, _, idx = mlp.route(cfg, p["router"], x.reshape(-1, d))
    pos = mlp._position_in_expert(idx.reshape(-1), E)
    assert bool((pos >= mlp.moe_capacity(cfg, 256)).any())      # drops
    assert bool((idx[-8:] == torch.arange(4)).all())             # ties
    gp = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
              if isinstance(v, dict) else v.to(cuda)) for k, v in p.items()}
    gx = x.to(cuda)
    mlp.moe_apply(cfg, gp, gx)                  # library set-up off the gate
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = mlp.moe_apply(cfg, gp, gx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs()
    assert bool((err <= 2e-5 * (1 + want.abs())).all()), float(err.max())
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


# -------------------------------------------------------- the module probe
def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_probe_on_the_card_emits_the_cpu_tokens(cuda, mode):
    """The reduced fp32 engine (dh 64, so B1 and B2 take it) with the
    per-module probe on the card emits the CPU engine's tokens and the
    untraced card engine's; its module spans are all there, and the
    loop's gauges are set."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    params = init_params(cfg, 0, device="cpu")

    def serve(dev, probe):
        eng = InferenceEngine(
            cfg, _to(params, dev), ClusterSpec.build([("A100", 1),
                                                      ("3090", 1)]),
            primary_ids=[0], pool_ids=[1],
            engine_cfg=EngineConfig(max_batch=8, max_seq=128, page_size=16,
                                    prefill_chunk=16, step_mode=mode,
                                    telemetry=probe, trace_modules=probe),
            device=dev)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=[
                int(x) for x in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(5, 60)))],
                max_new_tokens=8))
        assert eng.run_until_drained(500)
        return eng, {r.rid: r.output for r in eng.finished}

    eng, got = serve(cuda, True)
    assert got == serve("cpu", True)[1] == serve(cuda, False)[1]
    calls = eng.metrics["model_calls"]
    assert eng.tracer.count("attention") == cfg.n_layers * calls
    assert eng.tracer.count("lm_head") == calls
    snap = eng.snapshot()
    assert snap["xfer/h2d_gbps"] > 0.0 and eng._dense_eff != 0.5
    assert any(k.startswith("attn/device/") for k in snap)


def test_profile_attention_on_the_card(cuda):
    """The default 8 x 8 grid of (h, ctx) on the card: 64 samples, every
    one timed above zero."""
    from repro_torch.core.profiler import fit_attention_model, \
        profile_attention
    s = profile_attention(device="cuda")
    assert len(s) == 64 and all(t > 0.0 for _h, _g, t in s)
    assert len({(h, g) for h, g, _t in s}) == 64
    _model, r2 = fit_attention_model(s)
    assert r2 <= 1.0


# ------------------------------------------ families off the engine's path
# the reduced configs at head dims the flash kernel is built for
FAMILY_GPU = {
    "hymba-1.5b": dict(head_dim=64),
    "deepseek-v3-671b": dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                             v_head_dim=128, head_dim=192),
    "xlstm-350m": {},
    "internvl2-1b": dict(head_dim=64),
}


@pytest.mark.parametrize("impl", ["carry", "stacked"])
@pytest.mark.parametrize("name", sorted(FAMILY_GPU))
def test_family_on_the_card_emits_the_cpu_tokens(cuda, name, impl):
    """The reduced fp32 family on the card (the flash kernel in prefill)
    against the same model on the CPU: 8 greedy tokens identical."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config(name), decode_impl=impl,
                              **FAMILY_GPU[name])
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (3, 40)))}
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = torch.randn(3, cfg.n_prefix_embeds,
                                            cfg.d_model)
    P = cfg.n_prefix_embeds
    lens = torch.tensor([40 + P, 31 + P, 17 + P], dtype=torch.int32)

    def generate(dev):
        before = fa_ops.LAUNCHES["flash_attention"]
        p, b = _to(params, dev), _to(batch, dev)
        logits, cache = T.prefill(cfg, p, b, 40 + P + 8, lens.to(dev))
        if dev != "cpu":
            assert fa_ops.LAUNCHES["flash_attention"] - before == (
                0 if cfg.xlstm_pattern else cfg.n_layers)
        toks = [logits.argmax(-1)]
        for _ in range(7):
            logits, cache = T.decode_step(cfg, p, cache, toks[-1][:, None])
            toks.append(logits.argmax(-1))
        return torch.stack(toks, 1).cpu()

    assert torch.equal(generate(cuda), generate("cpu"))


def test_hubert_on_the_card_matches_the_cpu(cuda):
    """The reduced fp32 encoder (dh 80, non-causal) through
    ``forward_hidden`` on the card against the CPU: hidden states within
    1e-4."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("hubert-xlarge"), head_dim=80)
    params = init_params(cfg, 0, device="cpu")
    frames = torch.randn(2, 150, cfg.d_model,
                         generator=torch.Generator().manual_seed(0))
    want, _ = T.forward_hidden(cfg, params, {"frames": frames})
    got, _ = T.forward_hidden(cfg, _to(params, cuda),
                              {"frames": frames.to(cuda)})
    assert (got.cpu() - want).abs().max() <= 1e-4


@pytest.mark.parametrize("name", ["qwen3-14b", "qwen1.5-0.5b", "dbrx-132b"])
def test_reduced_training_on_the_card_matches_the_cpu(cuda, name):
    """Five steps of the reduced fp32 model (dh 64, so B3 and its backward
    take it) on the card against the CPU from the same weights: losses
    within 1e-5, the parameters within 1e-5 relative L2 over all leaves
    (a leaf of a few lr, such as a zero-initialised bias, moves apart by
    more of its own norm: AdamW steps every element by about lr)."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig, train
    from repro_torch.training.tree import flatten
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config(name), head_dim=64)
    params = init_params(cfg, 0, device="cpu")
    dcfg = DataConfig(cfg.vocab_size, seq_len=80, global_batch=4)
    before = fa_ops.LAUNCHES["flash_attention_bwd_dq"]
    runs = [train(cfg, dcfg, TrainConfig(steps=5, lr=1e-3, device=dev),
                  params=params) for dev in ("cpu", "cuda")]
    assert fa_ops.LAUNCHES["flash_attention_bwd_dq"] - before \
        == 5 * cfg.n_layers
    for a, b in zip(runs[1]["losses"], runs[0]["losses"]):
        assert abs(a - b) <= 1e-5
    a = torch.cat([p.detach().cpu().reshape(-1)
                   for p in flatten(runs[1]["params"])[0]])
    b = torch.cat([p.detach().reshape(-1)
                   for p in flatten(runs[0]["params"])[0]])
    assert torch.linalg.vector_norm(a - b) \
        <= 1e-5 * torch.linalg.vector_norm(b)


def test_reduced_deepseek_trains_on_the_card_like_the_cpu(cuda):
    """Three steps of reduced fp32 deepseek-v3 at MLA's head dims
    (``FAMILY_GPU``: q/k 192, v 128), every attention layer through B3 and
    its (192, 128) backward on the card, against the CPU from the same
    weights: losses within 1e-5, the parameters within 1e-5 relative L2
    over all leaves."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig, train
    from repro_torch.training.tree import flatten
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("deepseek-v3-671b"),
                              **FAMILY_GPU["deepseek-v3-671b"])
    params = init_params(cfg, 0, device="cpu")
    dcfg = DataConfig(cfg.vocab_size, seq_len=80, global_batch=4)
    before = dict(fa_ops.LAUNCHES)
    runs = [train(cfg, dcfg, TrainConfig(steps=3, lr=1e-3, device=dev),
                  params=params) for dev in ("cpu", "cuda")]
    assert {n: fa_ops.LAUNCHES[n] - before[n] for n in fa_ops.BWD_KERNELS} \
        == {n: 3 * cfg.n_layers for n in fa_ops.BWD_KERNELS}
    for a, b in zip(runs[1]["losses"], runs[0]["losses"]):
        assert abs(a - b) <= 1e-5
    a = torch.cat([p.detach().cpu().reshape(-1)
                   for p in flatten(runs[1]["params"])[0]])
    b = torch.cat([p.detach().reshape(-1)
                   for p in flatten(runs[0]["params"])[0]])
    assert torch.linalg.vector_norm(a - b) \
        <= 1e-5 * torch.linalg.vector_norm(b)


# -------------------------------------------- captured paged calls (graphs)
def _small_engine(cfg, params, dev, mode, telemetry=False,
                  hosts=(("A100", 1), ("3090", 1))):
    """The reduced engine on ``dev`` serving 6 requests under ``mode``,
    an A100 primary and (by default) a 3090 pool shard: (tokens by request
    id, the engine)."""
    import numpy as np
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
    eng = InferenceEngine(
        cfg, _to(params, dev), ClusterSpec.build(list(hosts)),
        primary_ids=[0], pool_ids=list(range(1, len(hosts))),
        engine_cfg=EngineConfig(max_batch=8, max_seq=128, page_size=16,
                                prefill_chunk=16, step_mode=mode,
                                telemetry=telemetry),
        device=dev)
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=[
            int(x) for x in rng.integers(0, cfg.vocab_size,
                                         int(rng.integers(5, 60)))],
            max_new_tokens=8))
    assert eng.run_until_drained(500)
    return {r.rid: r.output for r in eng.finished}, eng


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_captured_engine_emits_the_cpu_and_eager_tokens(cuda, mode):
    """The reduced fp32 engine (dh 64) on the card, its paged calls
    captured one graph per shape and replayed, emits the CPU engine's
    tokens and those of a ``disable_capture()`` run on the card; the
    kernels' launch counts after the captured run equal the eager run's
    (replays counted, captures not), and the graphs stay within the
    bucket counts."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.serving import graphs
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    params = init_params(cfg, 0, device="cpu")
    counts = []
    for run in ("captured", "eager"):
        for t in (ops.LAUNCHES, ops.PREFILL_TILE_LAUNCHES):
            for k in t:
                t[k] = 0
        with (graphs.disable_capture() if run == "eager"
              else contextlib.nullcontext()):
            got, eng = _small_engine(cfg, params, cuda, mode)
        torch.cuda.synchronize()
        counts.append((dict(ops.LAUNCHES), dict(ops.PREFILL_TILE_LAUNCHES)))
        wrappers = {"fused": (eng._fused_fn,),
                    "split": (eng._chunk_fn, eng._paged_fn)}[mode]
        if run == "captured":
            captured = got
            assert wrappers[-1].replays > 0     # the fused or decode call
            assert [len(w.entries) for w in wrappers] \
                == [w._cache_size() for w in wrappers]
            if mode == "fused":
                assert len(eng._fused_fn.entries) <= eng.fused_bucket_count()
            else:
                assert len(eng._chunk_fn.entries) \
                    <= eng.prefill_bucket_count()
                assert len(eng._paged_fn.entries) <= eng.bucket_count()
        else:
            assert not any(w.entries or w.replays for w in wrappers)
    assert captured == got == _small_engine(cfg, params, "cpu", mode)[0]
    assert counts[0] == counts[1]
    b1 = counts[0][0]["paged_prefill_attention"]
    assert b1 > 0 and sum(counts[0][1].values()) == b1


def _fused_inputs(cfg, rows, C, Pp, page, slot0, sink, seed):
    """Host arrays of one fused step on a single pool shard (no exchange
    lanes): ``rows`` of (start, n) over fresh page chains from slot
    ``slot0`` on."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B, Hkv = len(rows), cfg.n_kv_heads
    tables = (slot0 + rng.permutation(B * Hkv * Pp)).reshape(
        B, Hkv, Pp).astype(np.int32)
    lengths = np.array([s + n for s, n in rows], np.int32)
    starts = np.array([s for s, _ in rows], np.int32)
    wslots = np.full((B, Hkv, C), sink, np.int32)
    woffs = np.zeros((B, C), np.int32)
    toks = np.zeros((B, C), np.int32)
    for b, (s, n) in enumerate(rows):
        p = np.arange(s, s + n)
        wslots[b, :, :n] = tables[b][:, p // page]
        woffs[b, :n] = p % page
        toks[b, :n] = rng.integers(0, cfg.vocab_size, n)
    lanes = tuple(np.zeros((0,), np.int32) for _ in range(6))
    return lanes + (tables, lengths, starts, wslots, woffs, toks,
                    np.array([n - 1 for _, n in rows], np.int32))


def test_replayed_bf16_fused_steps_repeat_the_eager_steps_bit_for_bit(cuda):
    """bf16 fused steps at three shapes (a prefill chunk of C * r = 32
    folded rows: B1's wgmma tile; decode rows at r = 2: the decode tile;
    MHA decode rows: the split tile), each captured, then replayed in
    another order with the other entries' replays and eager launches of
    both kernels between: the logits and every pool slot the steps write
    (the sink aside: padded tokens' duplicate writes race there, and no
    length reaches it) equal the eager steps' bit for bit, and each replay
    counts one launch a layer on its tile."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import graphs
    from repro_torch.weights import init_params
    page, slots = 16, 512
    gqa = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64,
                              dtype="bfloat16")
    mha = dataclasses.replace(gqa, n_kv_heads=gqa.n_heads)
    cases = {"wgmma": (gqa, [(0, 16), (5, 11), (40, 16)], 16, 4),
             "tma": (gqa, [(70, 1), (3, 1), (150, 1), (0, 1)], 1, 16),
             "warp": (mha, [(33, 1), (90, 1)], 1, 8)}
    reg = MetricsRegistry()
    calls = {}
    for i, (tile, (cfg, rows, C, Pp)) in enumerate(cases.items()):
        assert ops.launch_tile(torch.bfloat16, C, cfg.gqa_ratio, page) \
            == tile
        g = torch.Generator(device=cuda).manual_seed(i)
        pools = [{0: torch.randn((cfg.n_layers, slots + 1, page,
                                  cfg.head_dim), generator=g, device=cuda)
                  .to(torch.bfloat16)} for _ in range(2)]
        fn = graphs.CapturedFn(
            lambda p, kp, vp, *a, cfg=cfg: T.sharded_fused_step(
                cfg, p, kp, vp, 0, slots, *a),
            reg.counter("jit/recompiles"), graphs.CudaGraphs(cuda))
        host = _fused_inputs(cfg, rows, C, Pp, page, 0, slots, i)
        calls[tile] = (cfg, fn, _to(init_params(cfg, i, device="cpu"),
                                    cuda), pools, host)

    def written(pools):
        return [p[0][:, :slots].clone() for p in pools]

    eager = {}
    for tile, (cfg, fn, params, pools, host) in calls.items():
        first = written(pools)
        with graphs.disable_capture():
            logits, _, _ = fn(params, *pools, *host)
        eager[tile] = (logits.clone(), written(pools))
        for p, w in zip(pools, first):            # back to the start
            p[0][:, :slots] = w
        calls[tile] += (first,)
    args = make(cuda, torch.bfloat16, **SHAPES[3])
    dargs = make_decode(cuda, torch.bfloat16, **DECODE_SHAPES[0])
    for tile in ("wgmma", "tma", "warp", "tma", "wgmma", "warp", "wgmma"):
        cfg, fn, params, pools, host, first = calls[tile]
        for p, w in zip(pools, first):
            p[0][:, :slots] = w
        before = dict(ops.PREFILL_TILE_LAUNCHES)
        logits, _, _ = fn(params, *pools, *host)
        torch.cuda.synchronize()
        assert ops.PREFILL_TILE_LAUNCHES[tile] - before[tile] \
            == cfg.n_layers
        assert torch.equal(logits, eager[tile][0]), tile
        for a, b in zip(written(pools), eager[tile][1]):
            assert torch.equal(a, b), tile
        ops.paged_prefill_attention(*args)        # eager launches between
        ops.paged_attention(*dargs)
    assert {t: (len(c[1].entries), c[1].replays) for t, c in calls.items()} \
        == {"wgmma": (1, 2), "tma": (1, 1), "warp": (1, 1)}


# ------------------------------------- the call clock and the host spans
CALLS = {"fused": ("fused_step",), "split": ("prefill_chunk",
                                             "paged_decode")}


def _traced_calls(spans, mode):
    """(call span, its graph span, its pack's args) of each paged call:
    spans are recorded as they close, so a call's pack and graph span
    close before it."""
    out, note, graph = [], None, None
    for sp in spans:
        if sp.name == "pack" and sp.args:
            note = sp.args
        elif sp.name.startswith("graph/"):
            graph = sp
        elif sp.name in CALLS[mode]:
            out.append((sp, graph, note))
            note = graph = None
    return out


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_replayed_calls_carry_their_device_and_exchange_ms(cuda, mode):
    """The traced reduced engine on the card emits the untraced engine's
    tokens; every call from a graph carries the call clock's
    ``device_ms`` and ``exchange_ms``, 0 <= exchange < device, and a call
    that staged pages from the pool shard spent some of it there."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    params = init_params(cfg, 0, device="cpu")
    got, eng = _small_engine(cfg, params, cuda, mode, telemetry=True)
    assert got == _small_engine(cfg, params, cuda, mode)[0]
    calls = _traced_calls(eng.tracer.spans(track="main"), mode)
    assert len(calls) == eng.metrics["model_calls"]
    replayed = [(sp.args, note) for sp, graph, note in calls
                if graph.name == "graph/replay"]
    assert replayed
    for args, note in replayed:
        assert 0 <= args["exchange_ms"] < args["device_ms"], args
        if note["gather_lanes"]:
            assert args["exchange_ms"] > 0, (args, note)
    assert any(note["gather_lanes"] for _, note in replayed)


def test_a_call_without_exchange_lanes_reads_no_exchange_time(cuda):
    """One device, no pool shard: no call has exchange lanes (Gp == 0),
    and each reads at most 0.05 ms between its exchange marks."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    params = init_params(cfg, 0, device="cpu")
    _, eng = _small_engine(cfg, params, cuda, "fused", telemetry=True,
                           hosts=(("A100", 1),))
    calls = _traced_calls(eng.tracer.spans(track="main"), "fused")
    assert calls and all(note["gather_lanes"] == 0 for _, _, note in calls)
    replayed = [sp.args for sp, graph, _ in calls
                if graph.name == "graph/replay"]
    assert replayed
    for args in replayed:
        assert args["device_ms"] > 0 and args["exchange_ms"] <= 0.05, args


# how far the device trace, on the host's clock through the marker, may
# read from the host's spans: on an H100 the last operation before a sync
# read up to 34 µs after the host's return from it; a replay's launch
# takes ms
SKEW = 2e-4


def test_replays_run_on_the_device_inside_their_spans(cuda):
    """Under ``torch.profiler``, its trace put on the host's clock by the
    benchmark's marker (``bench/trace.py``): each replayed call's device
    work (its staging copy, its graph's kernels: what starts after the
    step's ``pack`` closed) starts after the call's ``graph/replay`` span
    opened and ends before its ``wait`` span closed, to ``SKEW``, so the
    tracer's clock and the device trace's agree.  A request served once to
    capture its shapes, then again under the profiler."""
    import dataclasses
    import sys
    from pathlib import Path
    from repro_torch.configs import smoke_config
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
    from repro_torch.weights import init_params
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench.trace import DeviceTrace
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    eng = InferenceEngine(
        cfg, _to(init_params(cfg, 0, device="cpu"), cuda),
        ClusterSpec.build([("A100", 1), ("3090", 1)]), primary_ids=[0],
        pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=8, max_seq=128, page_size=16,
                                prefill_chunk=16, telemetry=True),
        device=cuda)
    prompt = [(5 * k + 1) % cfg.vocab_size for k in range(40)]
    for rid in (0, 1):
        if rid == 1:
            trace = DeviceTrace()
            trace.start()
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=12))
        assert eng.run_until_drained(100)
    trace.stop()
    acts, _ = trace.intervals()
    spans = [sp for sp in eng.tracer.spans(track="main")
             if sp.ts >= trace.t_start]
    assert eng.tracer.count("rebalance") == 0
    lo, checked, replay = trace.t_start, 0, None
    for sp in spans:                     # in the order they closed
        if sp.name == "pack":
            lo = sp.ts + sp.dur
        elif sp.name == "graph/replay":
            replay = sp
        elif sp.name == "graph/capture":
            replay = None
        elif sp.name == "wait" and replay is not None:
            end = sp.ts + sp.dur
            mine = [(s, e) for s, e, _ in acts if lo < s <= end + SKEW]
            assert mine
            assert min(s for s, _ in mine) >= replay.ts - SKEW
            assert max(e for _, e in mine) <= end + SKEW
            checked += 1
            replay = None
    assert checked >= 10


# ------------------------- the train step and profile_attention captured
def card_train(cfg, steps, **tcfg):
    """``train`` of reduced ``cfg`` on the card from the CPU's seeded
    weights (seq 80, batch 4, lr 1e-3), with its B3 launches."""
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig, train
    from repro_torch.weights import init_params
    before = dict(fa_ops.LAUNCHES)
    out = train(cfg, DataConfig(cfg.vocab_size, seq_len=80, global_batch=4),
                TrainConfig(steps=steps, lr=1e-3, device="cuda", **tcfg),
                params=init_params(cfg, 0, device="cpu"))
    out["launches"] = {k: v - before.get(k, 0)
                       for k, v in fa_ops.LAUNCHES.items()}
    return out


@pytest.mark.parametrize("name", ["qwen3-14b", "dbrx-132b"])
def test_captured_training_on_the_card_equals_eager(cuda, name):
    """Reduced fp32 (dh 64) for 5 steps: captured (one graph, 4 replays)
    against ``disable_capture()``: equal losses and parameters bit for
    bit, and exact launch counts over the replays."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.serving import graphs
    from repro_torch.training.tree import flatten
    cfg = dataclasses.replace(smoke_config(name), head_dim=64)
    got = card_train(cfg, 5)
    with graphs.disable_capture():
        want = card_train(cfg, 5)
    assert got["graphs"]["graphs"] == 1 and got["graphs"]["replays"] == 4
    assert got["losses"] == want["losses"]
    assert got["launches"] == want["launches"] == {
        k: 5 * cfg.n_layers * (2 if cfg.remat and k == "flash_attention"
                               else 1) for k in fa_ops.LAUNCHES
        if k == "flash_attention" or k in fa_ops.BWD_KERNELS}
    for a, b in zip(flatten(got["params"])[0], flatten(want["params"])[0]):
        assert torch.equal(a, b)


def test_a_restore_on_the_card_captures_anew(cuda, tmp_path):
    """3 captured steps and a checkpoint, then 3 more captured on the
    restored tensors: the 6 losses equal 6 straight captured steps'."""
    import dataclasses
    from repro_torch.configs import smoke_config
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    a = card_train(cfg, 3, ckpt_dir=str(tmp_path), ckpt_every=3)
    b = card_train(cfg, 6, ckpt_dir=str(tmp_path), ckpt_every=3)
    straight = card_train(cfg, 6)
    assert b["graphs"]["graphs"] == 1 and b["graphs"]["replays"] == 2
    assert a["losses"] + b["losses"] == straight["losses"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_profile_attention_replay_equals_the_eager_call(cuda, dtype):
    """A few grid points: each replay's output equals ``decode_attn``
    eagerly, bit for bit; the captured and eager samples cover the same
    grid with positive times."""
    from repro_torch.core import profiler
    from repro_torch.serving import graphs
    from repro_torch.telemetry.metrics import Counter
    g = torch.Generator(device=cuda).manual_seed(0)
    for h, ctx in ((1, 64), (8, 512), (24, 1536)):
        q, k, v = (torch.randn(s, generator=g, dtype=dtype, device=cuda)
                   for s in ((4, h, 1, 128), (4, h, ctx, 128),
                             (4, h, ctx, 128)))
        call = graphs.CapturedFn(profiler.decode_attn, Counter("c"),
                                 graphs.CudaGraphs(cuda))
        call(q, k, v)
        got = call(q, k, v).clone()
        assert call.replays == 1
        assert torch.equal(got, profiler.decode_attn(q, k, v))
    kw = dict(head_dim=128, head_grid=(1, 8), ctx_grid=(64, 1536),
              dtype=dtype, device=cuda)
    got = profiler.profile_attention(**kw)
    with graphs.disable_capture():
        eager = profiler.profile_attention(**kw)
    assert [s[:2] for s in got] == [s[:2] for s in eager]
    assert all(t > 0 for *_, t in got + eager)
