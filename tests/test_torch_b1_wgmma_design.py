"""The design of B1's bf16 wgmma kernel (``csrc/paged_prefill_attention.cu``,
``paged_prefill_wgmma``: consumer groups of 64 folded rows sharing one
TMA-fed K/V ring of 64-key tiles, one box a page), held on the CPU.

``_b1_wgmma_emulation.emulate`` repeats the kernel's walk in plain PyTorch
(blocks of two or three row groups of one kv head -- two where three
would leave SMs idle, so each case runs as on an H100's 132 SMs and on a
card of one SM -- or of one group for each of two kv heads where C * r <=
64, in launch order; one tile
sequence a (row, kv head) from clamped table entries; each (group, tile)
classed and the class checked pair by pair; every tile a block does not
walk checked to hold no visible pair; exp2 in log2 units, P rounded to
bf16).  It is held against
the port's plain version and the reference's Pallas kernel (interpret
mode) on inputs made with numpy from a seed, at bf16 2e-2 (P rounded to
bf16 before PV, which the plain version does not do)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _b1_wgmma_emulation import (INTERIOR, MASKED, SKIP, emulate, groups,
                                 heads, launch_order)
from repro.kernels.paged_attention import (paged_prefill_attention as
                                           jax_paged_prefill)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import \
    paged_prefill_attention_ref

TOL = dict(rtol=2e-2, atol=2e-2)


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


# (B, Hkv, C, r, dh, page, maxp, starts, lengths): every case has more
# than 16 folded rows a (row, kv head) and a page the boxes take
CASES = {
    # decode rows in a 16-token bucket (80 rows: a block of three groups,
    # the third empty) and a padded row, dh 64
    "decode_in_bucket_r5_dh64": dict(B=3, Hkv=2, C=16, r=5, dh=64, page=16,
                                     maxp=12, starts=[150, 63, 0],
                                     lengths=[151, 64, 0]),
    # a partial chunk (10 of 16 tokens live) beside a full one, pages of
    # 8 keys, dh 128
    "partial_chunk_r5_dh128": dict(B=2, Hkv=1, C=16, r=5, dh=128, page=8,
                                   maxp=24, starts=[40, 100],
                                   lengths=[50, 116]),
    # MHA at phi3's dh 96: one group a kv head, two heads a block (M 32
    # <= 64); a decode row, a chunk and a padded row
    "mha_r1_dh96": dict(B=3, Hkv=2, C=32, r=1, dh=96, page=16, maxp=8,
                        starts=[90, 0, 0], lengths=[91, 32, 0]),
    # MHA past 64 rows at dh 96: two groups a block
    "mha_r1_c80_dh96": dict(B=1, Hkv=2, C=80, r=1, dh=96, page=32, maxp=4,
                            starts=[20], lengths=[100]),
    # lengths past the table (only its 128 keys seen), dh 128, r 5, and a
    # row whose chunk starts past its length
    "lengths_past_table": dict(B=2, Hkv=1, C=8, r=5, dh=128, page=16,
                               maxp=8, starts=[10 ** 5, 60],
                               lengths=[10 ** 6, 30]),
    # r = 1 at dh 64 and r = 5 at 320 rows (two blocks a (row, kv head)):
    # the fused step's 64-token bucket at qwen3-14b's r
    "bucket_c64_r5": dict(B=2, Hkv=1, C=64, r=5, dh=64, page=16, maxp=12,
                          starts=[170, 0], lengths=[171, 64]),
    "mha_r1_dh64": dict(B=2, Hkv=2, C=24, r=1, dh=64, page=64, maxp=3,
                        starts=[0, 131], lengths=[24, 150]),
    # the other (r, dh) pairs: MHA at dh 128 (3 kv heads: a block of
    # one), r = 5 at dh 96
    "mha_r1_dh128": dict(B=2, Hkv=3, C=40, r=1, dh=128, page=16, maxp=8,
                         starts=[77, 0], lengths=[78, 40]),
    "decode_in_bucket_r5_dh96": dict(B=2, Hkv=1, C=16, r=5, dh=96, page=16,
                                     maxp=8, starts=[120, 0],
                                     lengths=[121, 0]),
}


def tensors(case, dtype=torch.bfloat16):
    t = [torch.from_numpy(case[k]).to(dtype) for k in ("q", "k", "v")]
    return t + [torch.from_numpy(case[k]) for k in
                ("tables", "lengths", "starts")]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wgmma_emulation_matches_plain_and_pallas(name, sms):
    shape = CASES[name]
    case = make_case(sorted(CASES).index(name), **shape)
    assert ops.prefill_tile(torch.bfloat16, shape["C"], shape["r"],
                            shape["page"]) == "wgmma"
    args = tensors(case)
    classes = {}
    got = emulate(*args, classes=classes, sms=sms)
    assert got.shape == case["q"].shape and got.dtype == torch.bfloat16
    assert got.transpose(1, 2).is_contiguous()
    got = got.float().numpy()
    ref = paged_prefill_attention_ref(*args).float().numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    jargs = [jnp.asarray(case[k], jnp.bfloat16) for k in ("q", "k", "v")] + [
        jnp.asarray(case[k]) for k in ("tables", "lengths", "starts")]
    kern = np.asarray(jax_paged_prefill(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL)
    assert np.all(got[case["lengths"] == 0] == 0)
    # every case walks a masked tile (each row's end) and computes
    assert classes.get(MASKED, 0) > 0


def test_out_of_range_table_entries_are_clamped():
    """Entries outside the pool are clamped into it per page box, as the
    reference clamps them; held against the plain version over the
    clamped table."""
    shape = CASES["partial_chunk_r5_dh128"]
    case = make_case(11, **shape)
    slots = case["k"].shape[0]
    case["tables"][:, :, 3:] = -5
    case["tables"][0, :, 6:] = slots + 40
    args = tensors(case)
    got = emulate(*args).float().numpy()
    clamped = torch.from_numpy(np.clip(case["tables"], 0, slots - 1))
    ref = paged_prefill_attention_ref(*args[:3], clamped,
                                      *args[4:]).float().numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    jargs = [jnp.asarray(case[k], jnp.bfloat16) for k in ("q", "k", "v")] + [
        jnp.asarray(case[k]) for k in ("tables", "lengths", "starts")]
    kern = np.asarray(jax_paged_prefill(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL)


def poisoned(case):
    """The case's pools with NaN in every row past each row's length (the
    last page's tail, the table row's later pages, a padded row's pages)
    and in the slots no table names; the table must not name slot 0, so
    that it is one of those (the producer's slot for pages past the table
    row)."""
    k, v, tables = case["k"].copy(), case["v"].copy(), case["tables"]
    slots, page, _ = k.shape
    B, Hkv, maxp = tables.shape
    for b in range(B):
        length = min(max(int(case["lengths"][b]), 0), maxp * page)
        for h in range(Hkv):
            for kpos in range(length, maxp * page):
                slot = tables[b, h, kpos // page]
                k[slot, kpos % page] = v[slot, kpos % page] = np.nan
    unnamed = np.setdiff1d(np.arange(slots), tables)
    assert 0 in unnamed
    k[unnamed] = v[unnamed] = np.nan
    return dict(case, k=k, v=v)


@pytest.mark.parametrize("name, shape", [
    ("partial_chunk_r5_dh128", {}),
    ("mha_r1_dh96", {}),
    ("decode_in_bucket_r5_dh64", {}),
    # a table of 80 keys, not a whole number of 64-key tiles, and lengths
    # past it: the last tile's pages 5-7 are past the table row
    ("lengths_past_table", dict(maxp=5)),
])
def test_pool_contents_past_the_lengths_do_not_reach_the_output(name, shape):
    """Whatever the pools hold past each row's length, non-finite values
    too: the walk masks K's keys there and clears V's rows before P V,
    so the output is the one on finite pools; the plain version ignores
    them too (the reference multiplies them by P = 0)."""
    shape = dict(CASES[name], **shape)
    case = make_case(21, **shape)
    tables = case["tables"]             # slot 0 named by no table
    tables[tables == 0] = np.setdiff1d(np.arange(case["k"].shape[0]),
                                       tables)[0]
    clean = tensors(case)
    args = tensors(poisoned(case))
    assert not torch.isfinite(args[2].float()).all()
    got = emulate(*args)
    assert torch.isfinite(got.float()).all()
    ref = paged_prefill_attention_ref(*clean).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL)
    np.testing.assert_array_equal(
        paged_prefill_attention_ref(*args).float().numpy(), ref)
    jargs = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
             for t in clean[:3]] + [jnp.asarray(t.numpy()) for t in clean[3:]]
    kern = np.asarray(jax_paged_prefill(*jargs), np.float32)
    np.testing.assert_allclose(got.float().numpy(), kern, **TOL)


def test_tile_classes_at_the_fused_bucket():
    """The 64-token bucket at qwen3-14b's r (320 rows) on a card whose
    SMs two (row, kv head)s fill: two blocks of three groups a (row, kv
    head), the second with an empty third group.  A decode row
    (length 201): every row sees the whole context, so each live group
    computes 3 interior tiles and the last masked, and the empty group
    skips all 4.  A full chunk at 128-191: each group's rows end inside
    tile 2, which is masked, tiles 0-1 interior; the empty group skips 3.
    So 5 x 3 + 5 x 2 interior, 5 + 5 masked and 4 + 3 skipped."""
    shape = dict(B=2, Hkv=1, C=64, r=5, dh=128, page=16, maxp=16,
                 starts=[200, 128], lengths=[201, 192])
    case = make_case(3, **shape)
    classes = {}
    got = emulate(*tensors(case), classes=classes, sms=4)
    assert classes == {INTERIOR: 25, MASKED: 10, SKIP: 7}
    ref = paged_prefill_attention_ref(*tensors(case))
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               **TOL)


def test_launch_order_and_groups():
    """Blocks of a (row, kv head) launch together, last rows first; at 64
    rows or fewer one group a kv head and two heads a block (the last
    block of an odd Hkv holds one)."""
    assert groups(128, 320, 32, 8) == 3 and groups(96, 320, 32, 8) == 2
    assert groups(64, 64, 1, 1) == 1 and groups(96, 65, 32, 8) == 2
    # 4 rows x 8 kv heads x 2 blocks of three groups: 64 of 132 SMs
    assert groups(128, 320, 4, 8) == 2 and groups(128, 320, 9, 8) == 3
    assert heads(64) == 2 and heads(65) == 1
    order = launch_order(2, 2, 320, 128, sms=1)
    assert order[:4] == [(0, (0,), 1), (0, (0,), 0), (0, (1,), 1),
                         (0, (1,), 0)]
    assert len(order) == 2 * 2 * 2
    assert launch_order(2, 3, 64, 96) == [(0, (0, 1), 0), (0, (2,), 0),
                                          (1, (0, 1), 0), (1, (2,), 0)]


@pytest.mark.parametrize("C, r, page, dtype, tile", [
    (64, 5, 16, torch.bfloat16, "wgmma"),
    (64, 1, 8, torch.bfloat16, "wgmma"),
    (4, 5, 16, torch.bfloat16, "wgmma"),
    (3, 5, 16, torch.bfloat16, "split"),
    (1, 16, 16, torch.bfloat16, "split"),
    (64, 5, 4, torch.bfloat16, "shared"),
    (64, 5, 128, torch.bfloat16, "shared"),
    (64, 5, 16, torch.float32, "shared"),
])
def test_the_tile_is_chosen_by_shape_and_dtype(C, r, page, dtype, tile):
    assert ops.prefill_tile(dtype, C, r, page) == tile
