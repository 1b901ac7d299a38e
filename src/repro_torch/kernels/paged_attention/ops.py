"""Public wrappers of the paged-attention kernels.

  paged_attention          — decode attention, one new token per row
                             (``csrc/paged_attention.cu``; the split
                             schedule's decode call)
  paged_prefill_attention  — causal chunk attention
                             (``csrc/paged_prefill_attention.cu``; the fused
                             step and the split schedule's prefill call)

On CUDA tensors each launches its hand-written Hopper kernel (built at
first use); on CPU tensors it runs the plain PyTorch version, the role
``interpret=True`` plays for the reference's Pallas kernels off the TPU.
There is no fallback from one to the other: a CUDA call the kernel cannot
take raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
# (library name, source) of every kernel here, for build.build_all
SOURCES = (("paged_attention", CSRC / "paged_attention.cu"),
           ("paged_prefill_attention", CSRC / "paged_prefill_attention.cu"))
HEAD_DIMS = (64, 96, 128)
MAX_GROUP = 16                 # query rows per kv head the decode kernel takes
# keys per span of the decode kernel's context split (rounded to pages)
SPLIT_KEYS = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far, per wrapper (a run resets them to 0 and reads
# them back to show that its path went through the kernels)
LAUNCHES = {"paged_attention": 0, "paged_prefill_attention": 0}


# C signatures: tensor pointers, int sizes, then scale, dtype and stream
_ARGTYPES = {
    "paged_attention": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8,
    "paged_prefill_attention": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7,
}


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name, dict(SOURCES)[name])
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name] + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q, kpool, vpool, block_tables, *rows) -> None:
    """What both kernels take: ``q`` is (B, Hkv, ..., dh) as passed to the
    kernel, ``rows`` the (B,) per-row int vectors."""
    B, Hkv, dh = q.shape[0], q.shape[1], q.shape[-1]
    dev = q.device
    for name, t in (("kpool", kpool), ("vpool", vpool),
                    ("block_tables", block_tables)) + tuple(
                        (f"row vector {i}", t) for i, t in enumerate(rows)):
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
    if q.data_ptr() % 16 or kpool.data_ptr() % 16 or vpool.data_ptr() % 16:
        raise ValueError("q and pool base pointers must be 16-byte aligned")
    if block_tables.shape[:2] != (B, Hkv) or block_tables.ndim != 3:
        raise ValueError(f"block_tables must be ({B}, {Hkv}, max_pages), got "
                         f"{tuple(block_tables.shape)}")
    if any(t.shape != (B,) for t in rows):
        raise ValueError(f"lengths/starts must be ({B},)")


def paged_attention(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over the head-granular paged pool.

    q:            (B, Hkv, r, dh) new-token queries, grouped per kv head
    kpool/vpool:  (num_slots, page_size, dh) — one layer of the pools, a
                  view into the (L, slots, page, dh) pool (no copy)
    block_tables: (B, Hkv, max_pages) int — entries past the length may be
                  arbitrary ids; they are clipped into range
    lengths:      (B,) int tokens stored per row (0 pads: the output is 0)
    returns       (B, Hkv, r, dh)
    """
    if q.ndim != 4 or kpool.ndim != 3 or block_tables.ndim != 3:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    B, Hkv, r, dh = q.shape
    slots, page, _ = kpool.shape
    block_tables = block_tables.clamp(0, slots - 1)
    if not q.is_cuda:
        return paged_attention_ref(q, kpool, vpool, block_tables, lengths)
    qc = q.contiguous()
    _check(qc, kpool, vpool, block_tables, lengths)
    if r > MAX_GROUP:
        raise ValueError(f"{r} query rows per kv head; the kernel takes "
                         f"at most {MAX_GROUP}")
    fn = _library("paged_attention").paged_attention
    max_pages = block_tables.shape[-1]
    split_keys = page * max(1, SPLIT_KEYS // page)
    n_splits = -(-max_pages * page // split_keys)
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, r, dh), dtype=q.dtype, device=q.device)
    # fp32 partials of each context span: m, l (B, Hkv, S, r), acc (.., dh)
    m_part = torch.empty((B, Hkv, n_splits, r), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, Hkv, n_splits, r, dh), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        err = fn(qc.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                 B, Hkv, r, dh, page, max_pages, split_keys, n_splits,
                 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    LAUNCHES["paged_attention"] += 1
    return out


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
    M = C * r
    qf = q.reshape(B, Hkv, M, dh).contiguous()
    _check(qf, kpool, vpool, block_tables, lengths, starts)
    fn = _library("paged_prefill_attention").paged_prefill_attention
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
    LAUNCHES["paged_prefill_attention"] += 1
    return out.reshape(B, Hkv, C, r, dh)
