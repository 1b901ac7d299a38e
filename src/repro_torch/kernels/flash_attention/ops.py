"""Public wrapper of the dense flash-attention kernel
(``csrc/flash_attention.cu``; the dense prefill's attention,
``attention.gqa_full``).

On CUDA tensors it launches the hand-written Hopper kernel (built at first
use); on CPU tensors it runs the plain PyTorch version, the role
``interpret=True`` plays for the reference's Pallas kernel off the TPU.
There is no fallback from one to the other: a CUDA call the kernel cannot
take raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

CSRC = Path(__file__).resolve().parent / "csrc"
# (library name, source) of every kernel here, for build.build_all
SOURCES = (("flash_attention", CSRC / "flash_attention.cu"),)
# (q/k head dim, v head dim) pairs the kernel is built for: the served
# configs' widths, MLA's (192, 128) among them
HEAD_DIMS = ((64, 64), (80, 80), (96, 96), (128, 128), (192, 128))
FOLDED_ROWS = 64               # (position, query head) rows per block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far (a run resets it to 0 and reads it back to show
# that its path went through the kernel)
LAUNCHES = {"flash_attention": 0}

# C signature: q, k, v, out, strides; B, Hq, Hkv, Sq, Sk, dh, dv,
# causal, window; scale, dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention", dict(SOURCES)["flash_attention"])
    fn = lib.flash_attention               # the same object on every call
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes: (B, H, S, d) views of one device and dtype
    (float32 or bfloat16), (q/k's dh, v's dv) in HEAD_DIMS, Hq a multiple
    of Hkv, the head dim contiguous and every row starting on a 16-byte
    boundary."""
    B, Hq, Sq, dh = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B
            or k.shape[3] != dh):
        raise ValueError(f"k and v must be ({B}, Hkv, Sk, {dh}) and ({B}, "
                         f"Hkv, Sk, dv), got {tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"k/v on {k.device}/{v.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k and v must have q's dtype {q.dtype}, got "
                        f"{k.dtype}/{v.dtype}")
    if (dh, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {dh}, v {v.shape[3]}) not "
                         f"supported ({HEAD_DIMS})")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        if st[3] != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if t.data_ptr() % 16 or any(
                s % vec for s, n in zip(st[:3], t.shape) if n > 1):
            raise ValueError(f"{name}'s rows must start on 16-byte "
                             f"boundaries")
    # grid (Hkv, B, query tiles of FOLDED_ROWS folded rows)
    if (B > 65535 or k.shape[1] > 65535
            or -(-Sq * (Hq // k.shape[1]) // FOLDED_ROWS) > 65535):
        raise ValueError(f"grid too large: batch {B}, {k.shape[1]} kv "
                         f"heads, {Sq} queries of {Hq} heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    layout: str = "BHSD") -> torch.Tensor:
    """Dense flash attention.  layout "BHSD": q (B, Hq, Sq, dh), k
    (B, Hkv, Sk, dh), v (B, Hkv, Sk, dv); "BSHD" (the model's): q
    (B, Sq, Hq, dh), k (B, Sk, Hkv, dh), v (B, Sk, Hkv, dv); the output
    has q's layout, dtype and leading dims, and v's head dim dv (MLA's
    prefill: dh 192, dv 128; elsewhere dv == dh).

    GQA (query head h reads kv head h // (Hq / Hkv)), causal and/or
    sliding-window mask (``window`` > 0 keeps q_pos - k_pos < window),
    scale 1/sqrt(dh), rows that see no key are 0.  ``block_q`` and
    ``block_k`` are the Pallas kernel's tiling knobs, kept for the
    reference's signature: the CUDA kernel tiles by its own constants and
    needs no padding.

    On CUDA tensors bf16 runs both products on the tensor cores and fp32
    on the CUDA cores (never TF32), chosen by dtype alone.
    """
    if layout not in ("BHSD", "BSHD"):
        raise ValueError(f"layout {layout!r}: 'BHSD' or 'BSHD'")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if layout == "BSHD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    B, Hq, Sq, dh = q.shape
    dv = v.shape[3]
    if not q.is_cuda:
        out = flash_attention_ref(q, k, v, causal=causal, window=window)
        return out.transpose(1, 2) if layout == "BSHD" else out
    _check(q, k, v)
    if layout == "BSHD":
        out_l = torch.empty((B, Sq, Hq, dv), dtype=q.dtype, device=q.device)
        out = out_l.transpose(1, 2)
    else:
        out = out_l = torch.empty((B, Hq, Sq, dv), dtype=q.dtype,
                                  device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        err = _library().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, Hq, k.shape[1], Sq, k.shape[2], dh, dv, int(causal),
            int(window), 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out_l
