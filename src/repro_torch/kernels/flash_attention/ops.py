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
HEAD_DIMS = (64, 96, 128)
BLOCK_M = 64                   # query rows per block of the kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far (a run resets it to 0 and reads it back to show
# that its path went through the kernel)
LAUNCHES = {"flash_attention": 0}

# C signature: q, k, v, out, strides; B, Hq, Hkv, Sq, Sk, dh, causal,
# window; scale, dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention", dict(SOURCES)["flash_attention"])
    lib.flash_attention.argtypes = _ARGTYPES
    lib.flash_attention.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes: (B, H, S, dh) views of one device and dtype
    (float32 or bfloat16), dh in HEAD_DIMS, Hq a multiple of Hkv, the head
    dim contiguous and every row starting on a 16-byte boundary."""
    B, Hq, Sq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k and v must be ({B}, Hkv, Sk, {dh}), got "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
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
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported ({HEAD_DIMS})")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if t.data_ptr() % 16 or any(
                t.stride(i) % vec for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"{name}'s rows must start on 16-byte "
                             f"boundaries")
    if B > 65535 or -(-Sq // BLOCK_M) > 65535:
        raise ValueError(f"grid too large: batch {B}, {Sq} queries")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    layout: str = "BHSD") -> torch.Tensor:
    """Dense flash attention.  layout "BHSD": q (B, Hq, Sq, dh), k/v
    (B, Hkv, Sk, dh); "BSHD" (the model's): q (B, Sq, Hq, dh), k/v
    (B, Sk, Hkv, dh); the output has q's layout, shape and dtype.

    GQA (query head h reads kv head h // (Hq / Hkv)), causal and/or
    sliding-window mask (``window`` > 0 keeps q_pos - k_pos < window),
    rows that see no key are 0.  ``block_q``/``block_k`` are the Pallas
    kernel's tiling knobs, kept for the reference's signature: the CUDA
    kernel tiles by its own constants and needs no padding.
    """
    if layout not in ("BHSD", "BSHD"):
        raise ValueError(f"layout {layout!r}: 'BHSD' or 'BSHD'")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if layout == "BSHD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    B, Hq, Sq, dh = q.shape
    if not q.is_cuda:
        out = flash_attention_ref(q, k, v, causal=causal, window=window)
        return out.transpose(1, 2) if layout == "BSHD" else out
    _check(q, k, v)
    if layout == "BSHD":
        out_l = torch.empty((B, Sq, Hq, dh), dtype=q.dtype, device=q.device)
        out = out_l.transpose(1, 2)
    else:
        out = out_l = torch.empty((B, Hq, Sq, dh), dtype=q.dtype,
                                  device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        t.stride(i) for t in (q, k, v, out) for i in range(3)))
    with torch.cuda.device(q.device):
        err = _library().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, Hq, k.shape[1], Sq, k.shape[2], dh, int(causal),
            int(window), 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out_l
