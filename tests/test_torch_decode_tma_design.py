"""The design of the decode tile (``csrc/paged_decode_tma.cuh``: B2's bf16
launches and B1's at C * r <= 16, a page in ``ops.WGMMA_PAGES``), held on
the CPU.

``_decode_tma_emulation.emulate`` repeats the kernel's work: the live
64-key tiles of all (row, kv head)s split over a persistent grid by
``ops.tma_plan`` (the device's arithmetic: each (row, kv head) weighed as
its tiles plus ``ops.TMA_HEAD_COST``), K/V gathered a page box at a
time from clamped table entries, each tile classed and checked pair by
pair, V cleared past each length, exp2 in log2 units, P rounded to the
input type, covering blocks writing their output and the pieces of a
(row, kv head) that crosses blocks merged in span order by the block that
takes its last ticket.  It is held against the port's plain versions and
the reference's Pallas kernels (interpret mode) on inputs made with numpy
from a seed, at an H100's grid and at grids of 3 blocks and 1, at bf16
2e-2 (P rounded to bf16 before PV, which the plain versions do not do)
and fp32 2e-5 (the same function summed in another order)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _decode_tma_emulation import (GRID, INTERIOR, MASKED, emulate,
                                   shuffled, unsplit)
from repro.kernels.paged_attention import paged_attention as jax_decode
from repro.kernels.paged_attention import (paged_prefill_attention as
                                           jax_prefill)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
GRIDS = (GRID, 3, 1)

# decode (B2): (Hkv, r, dh, page, maxp, lengths[, bad]) -- lengths 0, 1,
# a page +- 1 and a 64-key tile +- 1, past the table; r 1, 5, 7, 16; dh
# 64, 96, 128; every page the boxes take
DECODE = {
    "edges_r5_dh128": dict(Hkv=2, r=5, dh=128, page=16, maxp=40,
                           lengths=[0, 1, 15, 16, 17, 63, 64, 65, 128, 600]),
    "past_table_r1_dh64": dict(Hkv=3, r=1, dh=64, page=8, maxp=20,
                               lengths=[10 ** 6, 159, 161, 0]),
    "r7_dh96": dict(Hkv=2, r=7, dh=96, page=32, maxp=8,
                    lengths=[256, 255, 33, 2]),
    "r16_dh64": dict(Hkv=1, r=16, dh=64, page=64, maxp=4,
                     lengths=[200, 64, 1]),
    "bad_tables_r5_dh96": dict(Hkv=2, r=5, dh=96, page=16, maxp=16,
                               lengths=[250, 3, 129], bad=True),
}
# chunks of C * r <= 16 folded rows (B1): (Hkv, C, r, dh, page, maxp,
# starts, nvalid) -- lengths = starts + nvalid, 0 where nvalid is 0; a
# negative one puts the length below the start
PREFILL = {
    "c2_r8_dh128": dict(Hkv=2, C=2, r=8, dh=128, page=16, maxp=16,
                        starts=[100, 0, 63, 5], nvalid=[2, 2, 1, 0]),
    "c16_r1_dh64": dict(Hkv=2, C=16, r=1, dh=64, page=8, maxp=32,
                        starts=[0, 40, 200], nvalid=[16, 10, 16]),
    "c3_r5_dh96": dict(Hkv=1, C=3, r=5, dh=96, page=16, maxp=24,
                       starts=[126, 0, 300, 50], nvalid=[3, 2, 3, -20]),
    "c1_r5_dh128": dict(Hkv=3, C=1, r=5, dh=128, page=32, maxp=8,
                        starts=[0, 63, 64, 200], nvalid=[1, 1, 1, 1]),
}


def decode_case(seed, Hkv, r, dh, page, maxp, lengths, bad=False):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    slots = B * Hkv * maxp + 3
    tables = rng.permutation(slots)[:B * Hkv * maxp].reshape(B, Hkv, maxp)
    if bad:          # entries out of the pool, before and past the length
        junk = rng.choice([-7, slots, slots + 99], size=tables.shape)
        tables = np.where(rng.random(tables.shape) < 0.3, junk, tables)
    return dict(q=rng.standard_normal((B, Hkv, r, dh)).astype(np.float32),
                k=rng.standard_normal((slots, page, dh)).astype(np.float32),
                v=rng.standard_normal((slots, page, dh)).astype(np.float32),
                tables=tables.astype(np.int32),
                lengths=np.asarray(lengths, np.int32))


def prefill_case(seed, Hkv, C, r, dh, page, maxp, starts, nvalid):
    rng = np.random.default_rng(seed)
    B = len(starts)
    slots = B * Hkv * maxp + 3
    tables = rng.permutation(slots)[:B * Hkv * maxp].reshape(B, Hkv, maxp)
    starts = np.asarray(starts, np.int32)
    nvalid = np.asarray(nvalid, np.int32)
    return dict(
        q=rng.standard_normal((B, Hkv, C, r, dh)).astype(np.float32),
        k=rng.standard_normal((slots, page, dh)).astype(np.float32),
        v=rng.standard_normal((slots, page, dh)).astype(np.float32),
        tables=tables.astype(np.int32),
        lengths=np.where(nvalid != 0, starts + nvalid, 0).astype(np.int32),
        starts=starts)


KEYS_OF = {"decode": ("q", "k", "v", "tables", "lengths"),
           "prefill": ("q", "k", "v", "tables", "lengths", "starts")}


def torch_args(case, kind, dtype):
    return [torch.from_numpy(case[x]).to(TDT[dtype]) for x in "qkv"] + [
        torch.from_numpy(case[x]) for x in KEYS_OF[kind][3:]]


@functools.lru_cache(maxsize=None)
def case_of(kind, name):
    if kind == "decode":
        return decode_case(sorted(DECODE).index(name), **DECODE[name])
    return prefill_case(sorted(PREFILL).index(name), **PREFILL[name])


@functools.lru_cache(maxsize=None)
def pallas(kind, name, dtype):
    case = case_of(kind, name)
    jargs = [jnp.asarray(case[x], JDT[dtype]) for x in "qkv"] + [
        jnp.asarray(case[x]) for x in KEYS_OF[kind][3:]]
    fn = jax_decode if kind == "decode" else jax_prefill
    return np.asarray(fn(*jargs), np.float32)


def plain(kind, args):
    q, k, v, tables, *rest = args
    tables = tables.clamp(0, k.shape[0] - 1)
    fn = paged_attention_ref if kind == "decode" \
        else paged_prefill_attention_ref
    return fn(q, k, v, tables, *rest).float().numpy()


def check(kind, name, dtype, grid):
    case = case_of(kind, name)
    args = torch_args(case, kind, dtype)
    classes = {}
    got = emulate(*args, grid=grid, classes=classes)
    assert got.shape == args[0].shape and got.dtype == TDT[dtype]
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, plain(kind, args), **TOL[dtype])
    np.testing.assert_allclose(got, pallas(kind, name, dtype), **TOL[dtype])
    assert np.all(got[case["lengths"] == 0] == 0)
    return classes


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_emulation_matches_plain_and_pallas(name, dtype, grid):
    shape = DECODE[name]
    # the card runs MHA (r = 1) on the split tile; the design holds there
    assert ops.decode_tile(torch.bfloat16, shape["page"], shape["r"]) == \
        ("tma" if shape["r"] > 1 else "warp")
    classes = check("decode", name, dtype, grid)
    assert classes.get(MASKED, 0) > 0


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(PREFILL))
def test_chunk_emulation_matches_plain_and_pallas(name, dtype, grid):
    shape = PREFILL[name]
    assert shape["C"] * shape["r"] <= ops.SPLIT_ROWS
    assert ops.launch_tile(torch.bfloat16, shape["C"], shape["r"],
                           shape["page"]) == \
        ("tma" if shape["r"] > 1 else "warp")
    classes = check("prefill", name, dtype, grid)
    assert classes.get(MASKED, 0) > 0


def test_long_contexts_take_interior_tiles():
    """Tiles that every row sees wholly run without the mask."""
    classes = check("decode", "edges_r5_dh128", "bfloat16", GRID)
    assert classes.get(INTERIOR, 0) > 0


def random_row_tiles(rng, B):
    return [int(x) for x in rng.choice([0, 1, 2, 3, 7, 31], size=B)]


@pytest.mark.parametrize("seed", range(6))
def test_plan_splits_the_units_evenly_and_covers_each_head_once(seed):
    """Every (row, kv head)'s tiles are walked once, in order; the blocks'
    unit ranges differ by at most one unit and each block walks exactly
    the tiles whose units lie in its range (a (row, kv head)'s
    TMA_HEAD_COST units come before its tiles); each block writes at
    most its two slots, and the merge reads a crossing (row, kv head)'s
    pieces from the slots its writers used, in span order."""
    rng = np.random.default_rng(seed)
    nts = random_row_tiles(rng, int(rng.integers(1, 40)))
    Hkv = int(rng.integers(1, 9))
    units = []                              # unit -> (b, h, tile or None)
    for b, nt in enumerate(nts):
        for h in range(Hkv if nt else 0):
            units += [(b, h, None)] * ops.TMA_HEAD_COST
            units += [(b, h, k) for k in range(nt)]
    for grid in (1, 2, 7, 64, GRID, 10 ** 4):
        U, G, walks = ops.tma_plan(nts, Hkv, grid)
        assert U == len(units) and G == min(grid, U)
        bounds = [ops.tma_block_start(g, U, G) for g in range(G + 1)]
        if G:
            sizes = np.diff(bounds)
            assert bounds[-1] == U and sizes.max() - sizes.min() <= 1
        seen, writers = {}, {}
        for g, w in enumerate(walks):
            want = [u for u in units[bounds[g]:bounds[g + 1]]
                    if u[2] is not None]
            got = [(b, h, k) for b, h, t0, t1, _ in w for k in range(t0, t1)]
            assert got == want
            for i, (b, h, t0, t1, slot) in enumerate(w):
                assert seen.get((b, h), 0) == t0 and t1 > t0
                seen[(b, h)] = t1
                if slot is None:
                    assert t0 == 0 and t1 == nts[b]
                else:
                    assert slot == 2 * g + (i > 0) and i in (0, len(w) - 1)
                    writers.setdefault((b, h), []).append(slot)
        assert seen == {(b, h): nt for b, nt in enumerate(nts) if nt
                        for h in range(Hkv)}
        for (b, h), ub in ops.tma_head_units(nts, Hkv).items():
            nt = nts[b]
            assert units[ub] == (b, h, None)
            want = writers.get((b, h), [])
            pieces = ops.tma_pieces(ub, nt, U, G)
            assert (len(pieces) > 1) == bool(want)
            assert pieces == (want if want else pieces)
            for k in range(nt):                  # block_of by brute force
                u = ub + ops.TMA_HEAD_COST + k
                g = ops.tma_block_of(u, U, G)
                assert bounds[g] <= u < bounds[g + 1]


def test_heads_that_share_a_block_and_one_that_crosses_many():
    """A batch of short rows on a grid of 2 puts several (row, kv head)s
    in one block, each written there; one long row on an H100's grid
    crosses dozens of blocks and is merged once."""
    case = decode_case(11, Hkv=4, r=5, dh=64, page=16, maxp=8,
                       lengths=[20, 64, 100, 1, 128, 0, 70, 33])
    args = torch_args(case, "decode", "bfloat16")
    trace = {}
    got = emulate(*args, grid=2, trace=trace)
    assert max(sum(s is None for *_, s in w) for w in trace["walks"]) >= 3
    np.testing.assert_allclose(got.float().numpy(), plain("decode", args),
                               **TOL["bfloat16"])
    case = decode_case(12, Hkv=1, r=5, dh=128, page=16, maxp=160,
                       lengths=[2500])
    args = torch_args(case, "decode", "bfloat16")
    trace = {}
    got = emulate(*args, grid=GRID, trace=trace)
    # 40 tiles and the row's fixed cost over 41 blocks: the first holds
    # only the fixed cost
    assert trace["G"] == 41 and len(trace["merged"]) == 1
    assert len(trace["merged"][0][1]) == 40
    np.testing.assert_allclose(got.float().numpy(), plain("decode", args),
                               **TOL["bfloat16"])


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_a_covering_block_is_bit_equal_to_an_unsplit_walk(kind):
    """A (row, kv head) that one block covers is written from its own walk,
    bit for bit what one block walking it whole writes; a crossing one
    merges to the same within fp32 rounding."""
    name = "edges_r5_dh128" if kind == "decode" else "c2_r8_dh128"
    case = case_of(kind, name)
    args = torch_args(case, kind, "float32")
    q, k, v, tables, lengths, *starts = args
    st = starts[0] if starts else None
    trace = {}
    got = emulate(*args, grid=5, trace=trace)
    covered = [(b, h) for w in trace["walks"] for b, h, *_, s in w
               if s is None]
    crossing = [bh for bh, _ in trace["merged"]]
    assert covered and crossing
    for b, h in covered:
        assert torch.equal(got[b, h], unsplit(q, k, v, tables, lengths, b,
                                              h, st))
    for b, h in crossing:
        torch.testing.assert_close(
            got[b, h], unsplit(q, k, v, tables, lengths, b, h, st),
            rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_the_merge_is_the_same_in_any_finishing_order(kind):
    """Whichever block finishes last merges, reading the pieces in span
    order: the output is the same bits under any order in which blocks
    finish, each crossing (row, kv head) is merged once and every ticket
    is left 0."""
    name = "edges_r5_dh128" if kind == "decode" else "c16_r1_dh64"
    args = torch_args(case_of(kind, name), kind, "bfloat16")
    first = {}
    want = emulate(*args, grid=7, trace=first)
    assert first["merged"]
    for seed in range(4):
        trace = {}
        got = emulate(*args, grid=7, order=shuffled(seed), trace=trace)
        assert torch.equal(got, want)
        assert sorted(bh for bh, _ in trace["merged"]) == \
            sorted(bh for bh, _ in first["merged"])
        assert not any(trace["tickets"].values())


def poisoned(args, kind):
    """NaN in every pool row past each row's length and in the slots no
    table names."""
    q, k, v, tables, lengths, *rest = args
    k, v = k.clone(), v.clone()
    page = k.shape[1]
    maxp = tables.shape[-1]
    pos = torch.arange(maxp * page)
    slot = tables.long().clamp(0, k.shape[0] - 1)[..., pos // page]
    row = (pos % page).expand_as(slot)
    past = (pos >= lengths.long().clamp(0, maxp * page)[:, None, None]
            ).expand_as(slot)
    k[slot[past], row[past]] = float("nan")
    v[slot[past], row[past]] = float("nan")
    named = torch.zeros(k.shape[0], dtype=torch.bool)
    named[tables.long().clamp(0, k.shape[0] - 1).flatten()] = True
    k[~named] = float("nan")
    v[~named] = float("nan")
    return [q, k, v, tables, lengths, *rest]


@pytest.mark.parametrize("kind, name", [("decode", "edges_r5_dh128"),
                                        ("decode", "past_table_r1_dh64"),
                                        ("prefill", "c2_r8_dh128"),
                                        ("prefill", "c3_r5_dh96")])
def test_pool_contents_past_the_lengths_do_not_reach_the_output(kind, name):
    """S is -inf past each row's end (a select) and V is cleared past the
    length before P V, so NaN there changes no bit of the output."""
    args = torch_args(case_of(kind, name), kind, "bfloat16")
    clean = emulate(*args, grid=7)
    got = emulate(*poisoned(args, kind), grid=7)
    assert torch.equal(got, clean)


def test_out_of_range_table_entries_are_clamped():
    """Entries outside the pool, before the length too, are clamped into
    it per page box, as the plain version over clamped tables reads."""
    shape = DECODE["bad_tables_r5_dh96"]
    case = case_of("decode", "bad_tables_r5_dh96")
    slots = case["k"].shape[0]
    live = np.broadcast_to(np.arange(shape["maxp"])[None, None]
                           * shape["page"] < case["lengths"][:, None, None],
                           case["tables"].shape)
    assert ((case["tables"] < 0) | (case["tables"] >= slots))[live].any()
    check("decode", "bad_tables_r5_dh96", "bfloat16", 3)


@pytest.mark.parametrize("dtype, C, r, page, launch, split", [
    (torch.bfloat16, 1, 5, 16, "tma", "tma"),
    (torch.bfloat16, 2, 8, 8, "tma", "tma"),
    (torch.bfloat16, 16, 1, 64, "warp", "warp"),
    (torch.bfloat16, 1, 1, 16, "warp", "warp"),
    (torch.bfloat16, 1, 2, 16, "tma", "tma"),
    (torch.bfloat16, 1, 5, 4, "warp", "warp"),
    (torch.bfloat16, 1, 5, 128, "warp", "warp"),
    (torch.float32, 1, 5, 16, "warp", "warp"),
    (torch.bfloat16, 4, 5, 16, "wgmma", "tma"),
    (torch.float32, 4, 5, 16, "shared", "warp"),
])
def test_the_kernel_is_chosen_by_dtype_and_shape(dtype, C, r, page, launch,
                                                 split):
    """bf16 at a page the boxes take runs the decode tile for B2 and for
    B1 at C * r <= 16 where a kv head has r > 1 query rows; fp32, other
    pages and MHA (r = 1) keep the one-warp split tile; past 16 rows B1
    keeps its wgmma and shared tiles."""
    assert ops.launch_tile(dtype, C, r, page) == launch
    assert ops.decode_tile(dtype, page, r) == split
    assert (ops.prefill_tile(dtype, C, r, page) == "split") == \
        (C * r <= ops.SPLIT_ROWS)


def test_scratch_is_sized_from_shapes_alone():
    """The decode tile's scratch is two pieces a block whatever the
    lengths: at an H100's grid, 16 rows and dh 128 about 4.4 MB."""
    n = ops.tma_scratch_floats(GRID, 16, 128)
    assert n == 2 * GRID * 16 * 130 and 4 * n < 5e6
    for seed in range(3):
        rng = np.random.default_rng(seed)
        nts = random_row_tiles(rng, 30)
        _, _, walks = ops.tma_plan(nts, 8, GRID)
        used = [s for w in walks for *_, s in w if s is not None]
        assert len(set(used)) == len(used) and all(s < 2 * GRID
                                                   for s in used)


def test_q_must_start_on_a_16_byte_boundary():
    """The decode tile copies q's rows whole, so the wrappers take q's
    strides only with q starting 16-byte aligned (16-byte multiple strides
    alone are not enough)."""
    flat = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16)
    aligned = flat[:-1].view(2, 1, 8, 64)
    shifted = flat[1:].view(2, 1, 8, 64)        # 2 bytes past the start
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 2
    assert ops._q_strides(aligned) == [512, 0, 64, 1]
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops._q_strides(shifted)
