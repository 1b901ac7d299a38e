"""Public wrapper of the chunked paged-prefill attention kernel.

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/paged_prefill_attention.cu``, built at first use); on CPU tensors
it runs the plain PyTorch version, the role ``interpret=True`` plays for
the reference's Pallas kernel off the TPU.  There is no fallback from one
to the other: a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_prefill_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_prefill_attention.cu"
HEAD_DIMS = (64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far (a run resets it to 0 and reads it back to show
# that its path went through the kernel)
LAUNCHES = 0


def _library() -> ctypes.CDLL:
    lib = build.load("paged_prefill_attention", SOURCE)
    fn = lib.paged_prefill_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q, kpool, vpool, block_tables, lengths, starts) -> None:
    B, Hkv, C, r, dh = q.shape
    dev = q.device
    for name, t in (("kpool", kpool), ("vpool", vpool),
                    ("block_tables", block_tables), ("lengths", lengths),
                    ("starts", starts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"pools must have q's dtype {q.dtype}, got "
                        f"{kpool.dtype}/{vpool.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported ({HEAD_DIMS})")
    if kpool.ndim != 3 or kpool.shape != vpool.shape or kpool.shape[2] != dh:
        raise ValueError(f"pools must be (slots, page, {dh}), got "
                         f"{tuple(kpool.shape)}/{tuple(vpool.shape)}")
    if not (kpool.is_contiguous() and vpool.is_contiguous()):
        raise ValueError("pools must be contiguous (a layer view kpool[idx] "
                         "of a contiguous (L, slots, page, dh) pool is)")
    if kpool.data_ptr() % 16 or vpool.data_ptr() % 16:
        raise ValueError("pool base pointers must be 16-byte aligned")
    if block_tables.shape[:2] != (B, Hkv) or block_tables.ndim != 3:
        raise ValueError(f"block_tables must be ({B}, {Hkv}, max_pages), got "
                         f"{tuple(block_tables.shape)}")
    if lengths.shape != (B,) or starts.shape != (B,):
        raise ValueError(f"lengths/starts must be ({B},)")


def paged_prefill_attention(q: torch.Tensor, kpool: torch.Tensor,
                            vpool: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor, starts: torch.Tensor
                            ) -> torch.Tensor:
    """Causal chunk attention over the head-granular paged pool (prefill).

    q:            (B, Hkv, C, r, dh) — one C-token prompt chunk per sequence,
                  queries grouped per kv head; the chunk's OWN K/V must
                  already be scattered into the pools
    kpool/vpool:  (num_slots, page_size, dh) — one layer of the pools, a
                  view into the (L, slots, page, dh) pool (no copy)
    block_tables: (B, Hkv, max_pages) int — entries past the written length
                  may be arbitrary ids; they are clipped into range
    lengths:      (B,) int keys visible after the chunk's writes (0 pads)
    starts:       (B,) int absolute position of each chunk's first token
    returns       (B, Hkv, C, r, dh)
    """
    global LAUNCHES
    if q.ndim != 5 or kpool.ndim != 3 or block_tables.ndim != 3:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    B, Hkv, C, r, dh = q.shape
    slots, page, _ = kpool.shape
    block_tables = block_tables.clamp(0, slots - 1)
    if not q.is_cuda:
        return paged_prefill_attention_ref(q, kpool, vpool, block_tables,
                                           lengths, starts)
    _check(q, kpool, vpool, block_tables, lengths, starts)
    fn = _library().paged_prefill_attention
    M = C * r
    qf = q.reshape(B, Hkv, M, dh).contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    sts = starts.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, M, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(qf.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), sts.data_ptr(),
                 out.data_ptr(), B, Hkv, M, r, dh, page, tables.shape[-1],
                 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out.reshape(B, Hkv, C, r, dh)
