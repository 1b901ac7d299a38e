"""Chunked paged-prefill attention: the port's wrapper on CPU tensors (its
plain version) against the reference's Pallas kernel (interpret mode,
through ``ops``) and its pure-jnp oracle, on identical inputs made with
numpy.  Tolerances are the reference's own (tests/test_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention import (paged_prefill_attention as
                                           jax_paged_prefill,
                                           paged_prefill_attention_ref as
                                           jax_paged_prefill_ref)
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ops

# fp32: 2e-5 (two fp32 softmax pipelines, summed in another order);
# bf16: 2e-2 (the kernel rounds P to bf16 before PV, the oracle does not)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_case(seed, B, Hkv, C, r, dh, page, maxp, starts, nvalid,
              bad_tables=False):
    """Inputs as numpy: a permuted slot table, per-row (start, n) spans;
    ``nvalid == 0`` makes a padded row (lengths 0).  ``bad_tables`` puts
    out-of-range ids (negative and past the pool) in the entries past
    each row's length, which the wrapper must clip."""
    rng = np.random.default_rng(seed)
    slots = B * Hkv * maxp + 3
    tables = rng.permutation(slots)[:B * Hkv * maxp].reshape(B, Hkv, maxp)
    starts = np.asarray(starts, np.int32)
    nvalid = np.asarray(nvalid, np.int32)
    lengths = np.where(nvalid > 0, starts + nvalid, 0).astype(np.int32)
    if bad_tables:
        for b in range(B):
            need = -(-int(lengths[b]) // page)
            tables[b, :, need:] = rng.choice([-7, slots + 5, 10 ** 6],
                                             size=tables[b, :, need:].shape)
    return dict(
        q=rng.standard_normal((B, Hkv, C, r, dh)).astype(np.float32),
        k=rng.standard_normal((slots, page, dh)).astype(np.float32),
        v=rng.standard_normal((slots, page, dh)).astype(np.float32),
        tables=tables.astype(np.int32), lengths=lengths, starts=starts)


CASES = {
    # decode rows: C = 1, start = ctx - 1
    "decode_r1": dict(B=3, Hkv=2, C=1, r=1, dh=16, page=8, maxp=4,
                      starts=[0, 9, 30], nvalid=[1, 1, 1]),
    "decode_r4": dict(B=2, Hkv=2, C=1, r=4, dh=64, page=16, maxp=3,
                      starts=[16, 40], nvalid=[1, 1]),
    # chunks crossing page boundaries, a partial chunk
    "chunk_cross_pages": dict(B=2, Hkv=2, C=8, r=2, dh=16, page=4, maxp=6,
                              starts=[2, 13], nvalid=[8, 5]),
    # mixed decode + prefill rows with a padded (lengths == 0) row
    "mixed_padded_row": dict(B=4, Hkv=2, C=4, r=2, dh=16, page=8, maxp=4,
                             starts=[20, 0, 0, 7], nvalid=[1, 4, 0, 3]),
    "dh64_prefill": dict(B=2, Hkv=1, C=16, r=3, dh=64, page=8, maxp=4,
                         starts=[0, 11], nvalid=[16, 9]),
}


def _run_both(case, dtype):
    jdt, tdt = JDT[dtype], TDT[dtype]
    jargs = (jnp.asarray(case["q"], jdt), jnp.asarray(case["k"], jdt),
             jnp.asarray(case["v"], jdt), jnp.asarray(case["tables"]),
             jnp.asarray(case["lengths"]), jnp.asarray(case["starts"]))
    targs = (torch.from_numpy(case["q"]).to(tdt),
             torch.from_numpy(case["k"]).to(tdt),
             torch.from_numpy(case["v"]).to(tdt),
             torch.from_numpy(case["tables"]),
             torch.from_numpy(case["lengths"]),
             torch.from_numpy(case["starts"]))
    got = ops.paged_prefill_attention(*targs).float().numpy()
    return jargs, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_pallas_kernel_and_oracle(name, dtype):
    case = make_case(seed=sorted(CASES).index(name), **CASES[name])
    jargs, got = _run_both(case, dtype)
    kern = np.asarray(jax_paged_prefill(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    # the oracle needs in-range tables (the wrapper clips, the oracle
    # gathers as given)
    ref = np.asarray(jax_paged_prefill_ref(*jargs), np.float32)
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    assert got.shape == case["q"].shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_of_range_tables_are_clipped(dtype):
    """Table entries past each row's length may be arbitrary — negative or
    past the pool — and are clipped into range, as the reference's
    wrapper does; the outputs match its kernel."""
    case = make_case(seed=7, bad_tables=True, **CASES["mixed_padded_row"])
    assert case["tables"].min() < 0
    assert case["tables"].max() >= case["k"].shape[0]
    jargs, got = _run_both(case, dtype)
    kern = np.asarray(jax_paged_prefill(*jargs), np.float32)
    np.testing.assert_allclose(got, kern, **TOL[dtype])


def test_padded_row_is_exactly_zero():
    case = make_case(seed=3, **CASES["mixed_padded_row"])
    _, got = _run_both(case, "float32")
    assert np.all(got[2] == 0.0)          # lengths == 0: l == 0 -> 0
    assert np.all(np.isfinite(got))


def test_cpu_tensors_never_touch_the_loader(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no build, no
    library load, no launch counted."""
    def boom(*a, **k):
        raise AssertionError("kernel loader touched for CPU tensors")
    monkeypatch.setattr(build, "load", boom)
    before = dict(ops.LAUNCHES)
    case = make_case(seed=1, **CASES["decode_r4"])
    _run_both(case, "float32")
    assert ops.LAUNCHES == before


def test_wrapper_rejects_bad_ranks():
    q = torch.zeros((1, 1, 4, 16))
    pool = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError, match="bad ranks"):
        ops.paged_prefill_attention(q, pool, pool,
                                    torch.zeros((1, 1, 2), dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32))
