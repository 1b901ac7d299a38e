"""The port's ``PagedHeadCache`` against the reference's: the allocation,
migration (including a refused one) and release scenarios of
tests/test_kvcache.py replayed on both, comparing block tables, lengths,
partitions' free lists, ``MigrationResult``s, pool contents and the step
plans' anchor-space indices and exchange lanes."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.config import ModelConfig as JConfig
from repro.serving.kvcache import PagedHeadCache as JCache
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving.kvcache import PagedHeadCache as TCache

SPEC = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, head_dim=16,
            dtype="float32")


def make_pair(slots=(8, 8), stage=8):
    devs = {i: n for i, n in enumerate(slots)}
    j = JCache(JConfig(**SPEC), devs, page_size=4, stage_slots=stage)
    t = TCache(TConfig(**SPEC), devs, page_size=4, stage_slots=stage,
               device="cpu")
    return j, t


def fill_pools(j, t, seed):
    """Identical random contents in both packages' pools."""
    rng = np.random.default_rng(seed)
    for d in j.kpools:
        for jp, tp in ((j.kpools, t.kpools), (j.vpools, t.vpools)):
            a = rng.standard_normal(jp[d].shape).astype(np.float32)
            jp[d] = jnp.asarray(a)
            tp[d].copy_(torch.from_numpy(a))


def assert_same_state(j, t, pools=False):
    assert j.tables == t.tables
    assert j.lengths == t.lengths
    assert {d: p.slots for d, p in j.partitions.items()} \
        == {d: p.slots for d, p in t.partitions.items()}
    assert j.sink == t.sink and j.stage == t.stage
    j.check_invariants()
    t.check_invariants()
    if pools:
        for d in j.kpools:
            np.testing.assert_array_equal(t.kpools[d].numpy(),
                                          np.asarray(j.kpools[d]))
            np.testing.assert_array_equal(t.vpools[d].numpy(),
                                          np.asarray(j.vpools[d]))


def same_result(a, b):
    return ((a.rid, a.group, a.dst_device, a.requested, a.moved, a.nbytes,
             a.complete, a.by_src)
            == (b.rid, b.group, b.dst_device, b.requested, b.moved,
                b.nbytes, b.complete, b.by_src))


def test_layout_and_byte_accounting():
    j, t = make_pair()
    for d in j.kpools:
        assert tuple(t.kpools[d].shape) == j.kpools[d].shape
    assert t.bytes_per_slot() == j.bytes_per_slot()
    assert t.free_bytes(1) == j.free_bytes(1)
    assert t.pool_dtype(TConfig(**dict(SPEC, dtype="bfloat16"))).itemsize \
        == j.pool_dtype(JConfig(**dict(SPEC, dtype="bfloat16"))).itemsize


def test_alloc_release_roundtrip():
    j, t = make_pair()
    for kv in (j, t):
        assert kv.ensure_capacity(0, 0, 0, 10)
        assert kv.ensure_capacity(0, 1, 1, 5)
    assert_same_state(j, t)
    assert j.release(0) == t.release(0) == 5
    assert_same_state(j, t)


def test_migration_copies_pool_contents():
    j, t = make_pair()
    for kv in (j, t):
        for g in range(2):
            kv.ensure_capacity(0, g, 0, 7)
            kv.ensure_capacity(1, g, g, 13)
    fill_pools(j, t, seed=0)
    for rid, g, dst in [(0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 0, 1)]:
        rj, rt = j.migrate_group(rid, g, dst), t.migrate_group(rid, g, dst)
        assert same_result(rj, rt), (rj, rt)
        assert_same_state(j, t, pools=True)
    assert j.release(1) == t.release(1)
    assert_same_state(j, t, pools=True)


def test_refused_migration_moves_nothing():
    j, t = make_pair(slots=(8, 1))
    for kv in (j, t):
        kv.ensure_capacity(0, 0, 0, 8)          # 2 pages, device 1 has 1
    fill_pools(j, t, seed=1)
    rj, rt = j.migrate_group(0, 0, 1), t.migrate_group(0, 0, 1)
    assert not rt.complete and same_result(rj, rt)
    assert tuple(rt) == (0, 0.0)
    assert_same_state(j, t, pools=True)


def test_exhaustion_returns_false():
    j, t = make_pair(slots=(2, 0))
    for kv in (j, t):
        assert kv.ensure_capacity(0, 0, 0, 8)
        assert not kv.ensure_capacity(1, 0, 0, 4)
    assert_same_state(j, t)


@pytest.mark.parametrize("page", [1, 4, 16])
def test_slots_per_token_group_equal(page):
    j = JCache(JConfig(**SPEC), {0: 4}, page_size=page)
    t = TCache(TConfig(**SPEC), {0: 4}, page_size=page, device="cpu")
    assert t.slots_per_token_group() == j.slots_per_token_group() == 1 / page


def test_free_slots_equal():
    j, t = make_pair(slots=(8, 3))
    for kv in (j, t):
        kv.ensure_capacity(0, 0, 0, 9)          # 3 pages on device 0
        kv.ensure_capacity(0, 1, 1, 4)          # 1 page on device 1
    assert [t.free_slots(d) for d in (0, 1)] \
        == [j.free_slots(d) for d in (0, 1)] == [5, 2]
    j.release(0)
    t.release(0)
    assert [t.free_slots(d) for d in (0, 1)] \
        == [j.free_slots(d) for d in (0, 1)] == [8, 3]


def test_block_table_equal():
    j, t = make_pair()
    for kv in (j, t):
        kv.ensure_capacity(0, 0, 0, 7)
        kv.ensure_capacity(0, 1, 1, 13)
        kv.migrate_group(0, 0, 1)
    for g in range(2):
        assert t.block_table(0, g) == j.block_table(0, g) \
            == t.tables[(0, g)]
    assert t.block_table(0, 1) is not t.tables[(0, 1)]
    assert t.block_table(5, 0) == j.block_table(5, 0) == []


def test_step_plans_match():
    j, t = make_pair()
    for kv in (j, t):
        for g in range(2):
            kv.ensure_capacity(0, g, g % 2, 11)   # group 1 remote
            kv.ensure_capacity(1, g, 0, 6)
    pj, pt = j.step_plan(), t.step_plan()
    rows = [(0, 10, 1), (1, 2, 4)]
    for a, b in zip(pj.mixed_scatter_indices(rows, 4),
                    pt.mixed_scatter_indices(rows, 4)):
        np.testing.assert_array_equal(a, b)
    for rid, n in [(0, 11), (1, 6)]:
        np.testing.assert_array_equal(pj.block_table_matrix(rid, 4, n),
                                      pt.block_table_matrix(rid, 4, n))
    assert pj.gather_count == pt.gather_count > 0
    assert pj.writeback_count == pt.writeback_count > 0
    assert pj.d2d_bytes() == pt.d2d_bytes()
    for a, b in zip(pj.exchange_arrays(8), pt.exchange_arrays(8)):
        np.testing.assert_array_equal(a, b)


def test_staging_exhaustion_raises_in_both():
    j, t = make_pair(stage=1)
    for kv in (j, t):
        kv.ensure_capacity(0, 0, 1, 8)          # 2 remote pages
        with pytest.raises(RuntimeError, match="staging region exhausted"):
            kv.step_plan().block_table_matrix(0, 2)


@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences(seed):
    """Allocation / release / migration sequences drawn from a seed,
    replayed on both caches; state compared after every operation."""
    rng = np.random.default_rng(seed)
    j, t = make_pair(slots=(6, 6))
    fill_pools(j, t, seed=seed)
    for _ in range(30):
        op = rng.choice(["alloc", "release", "migrate"])
        rid, dev, n = (int(rng.integers(0, 4)), int(rng.integers(0, 2)),
                       int(rng.integers(1, 25)))
        for kv in (j, t):
            if op == "alloc":
                for g in range(2):
                    if kv.ensure_capacity(rid, g, dev, n):
                        kv.lengths[(rid, g)] = n
            elif op == "release":
                kv.release(rid)
        if op == "migrate":
            for g in range(2):
                if (rid, g) in j.tables:
                    assert same_result(j.migrate_group(rid, g, dev),
                                       t.migrate_group(rid, g, dev))
        assert_same_state(j, t, pools=(op == "migrate"))
