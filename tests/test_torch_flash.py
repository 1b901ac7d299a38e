"""The dense flash-attention kernel's plain version (the CPU path of
``ops.flash_attention``) against the reference's Pallas
``flash_attention`` run in interpret mode, on the cases of
tests/test_kernels.py: the same numpy inputs through both, fp32 within
2e-5 and bf16 within 2e-2.  Then the wrapper's input checks, which run
before any launch."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def inputs(shapes, dtype, seed=0):
    """The same random arrays as a JAX and a torch triple, both rounded
    from fp32 to ``dtype`` the same way."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def assert_close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,dh", [
    (1, 4, 4, 128, 64),      # MHA
    (2, 8, 2, 256, 64),      # GQA r=4
    (1, 4, 1, 128, 128),     # MQA
    (2, 4, 2, 192, 32),      # non-power-of-two seq (the reference pads)
])
def test_flash_plain_vs_reference(dtype, B, Hq, Hkv, S, dh):
    (jq, jk, jv), (q, k, v) = inputs(
        [(B, Hq, S, dh), (B, Hkv, S, dh), (B, Hkv, S, dh)], dtype)
    want = jflash(jq, jk, jv, causal=True, block_q=64, block_k=64)
    got = flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert_close(got, want, dtype)


@pytest.mark.parametrize("window", [16, 48, 96])
def test_flash_plain_sliding_window(window):
    (jq, jk, jv), (q, k, v) = inputs(
        [(1, 4, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32)], "float32", 1)
    want = jflash(jq, jk, jv, causal=True, window=window, block_q=32,
                  block_k=32)
    got = flash_attention(q, k, v, causal=True, window=window)
    assert_close(got, want, "float32")


def test_flash_plain_non_causal_padded():
    (jq, jk, jv), (q, k, v) = inputs(
        [(1, 2, 100, 32), (1, 2, 100, 32), (1, 2, 100, 32)], "float32", 2)
    want = jflash(jq, jk, jv, causal=False, block_q=64, block_k=64)
    got = flash_attention(q, k, v, causal=False)
    assert_close(got, want, "float32")


def test_flash_plain_bshd_layout():
    (jq, jk, jv), (q, k, v) = inputs(
        [(1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32)], "float32", 3)
    want = jflash(jq, jk, jv, causal=True, layout="BSHD", block_q=32,
                  block_k=32)
    got = flash_attention(q, k, v, causal=True, layout="BSHD")
    assert got.shape == q.shape
    assert_close(got, want, "float32")


def bhsd(B=1, Hq=4, Hkv=2, S=64, dh=64, dtype=torch.float32):
    return (torch.zeros(B, Hq, S, dh, dtype=dtype),
            torch.zeros(B, Hkv, S, dh, dtype=dtype),
            torch.zeros(B, Hkv, S, dh, dtype=dtype))


@pytest.mark.parametrize("case, exc, match", [
    ("dh32", ValueError, "head dim"),
    ("fp16", TypeError, "dtype"),
    ("mixed", TypeError, "dtype"),
    ("groups", ValueError, "multiple"),
    ("kv", ValueError, "k and v"),
    ("strided", ValueError, "contiguous"),
    ("misaligned", ValueError, "16-byte"),
])
def test_wrapper_checks_what_the_kernel_takes(case, exc, match):
    """What a CUDA call would be refused for, checked on CPU tensors (the
    checks read only shapes, strides, dtypes and pointers)."""
    q, k, v = bhsd()
    if case == "dh32":
        q, k, v = bhsd(dh=32)
    elif case == "fp16":
        q, k, v = bhsd(dtype=torch.float16)
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "groups":
        q = q[:, :3]
    elif case == "kv":
        v = v[:, :, :32]
    elif case == "strided":
        k = k.transpose(2, 3)
    elif case == "misaligned":
        q = torch.zeros(1, 4, 64, 66)[..., 1:65]
    with pytest.raises(exc, match=match):
        ops._check(q, k, v)
    ops._check(*bhsd())
    ops._check(*bhsd(dh=96, dtype=torch.bfloat16))
