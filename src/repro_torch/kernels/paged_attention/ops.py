"""Public wrappers of the paged-attention kernels.

  paged_attention          — decode attention, one new token per row
                             (``csrc/paged_attention.cu``; the split
                             schedule's decode call)
  paged_prefill_attention  — causal chunk attention
                             (``csrc/paged_prefill_attention.cu``; the fused
                             step and the split schedule's prefill call):
                             in bf16 at more than SPLIT_ROWS folded rows a
                             (row, kv head) and a page in WGMMA_PAGES a
                             TMA-fed wgmma kernel, elsewhere the shared
                             mma.sync / FMA tile (``prefill_tile``)

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
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
# (library name, source) of every kernel here, for build.build_all
SOURCES = (("paged_attention", CSRC / "paged_attention.cu"),
           ("paged_prefill_attention", CSRC / "paged_prefill_attention.cu"))
HEAD_DIMS = (64, 96, 128)
# the split plan of both kernels: a (row, kv head) with at most SPLIT_ROWS
# folded query rows (every decode call's r query rows) is one one-warp tile
# (csrc/paged_block.cuh) whose keys are split into spans of whole key
# tiles
SPLIT_ROWS = 16
SPAN_ALIGN = 64                # a multiple of every key tile of the kernel
SPLIT_BLOCKS = 1024            # blocks the split plan aims to put on the card
# pages the prefill kernel's wgmma path reads as TMA boxes: a 64-key tile
# in boxes of whole 1024-byte swizzle groups
WGMMA_PAGES = (8, 16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far, per wrapper (a run resets them to 0 and reads
# them back to show that its path went through the kernels)
LAUNCHES = {"paged_attention": 0, "paged_prefill_attention": 0}


# C signatures: tensor pointers, int sizes, then scale, dtype and stream
_ARGTYPES = {
    "paged_attention": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2,
    "paged_prefill_attention": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2,
}


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name, dict(SOURCES)[name])
    fn = getattr(lib, name)                # the same object on every call
    if fn.argtypes is None:
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


def _q_strides(q: torch.Tensor) -> list:
    """q's strides as the kernels read them (elements; a size-1 dim's
    stride is never used and passes as 0): the last dim contiguous, the
    others 16-byte multiples."""
    strides = [0 if n == 1 else st for n, st in zip(q.shape, q.stride())]
    if strides[-1] not in (0, 1) or any(st * q.element_size() % 16
                                        for st in strides[:-1]):
        raise ValueError(f"q strides {tuple(q.stride())}: the last dim must "
                         f"be contiguous and the others 16-byte multiples")
    return strides


def _split_scratch(B: int, Hkv: int, C: int, r: int, dh: int,
                   n_splits: int, device
                   ) -> Tuple[Optional[torch.Tensor], list]:
    """The fp32 scratch of a split launch and pointers to its (acc, m, l)
    partials in it; (None, null pointers) where the keys are not split.
    The caller holds the tensor until the launch is enqueued."""
    n_scratch = split_scratch_floats(B, Hkv, C, r, dh, n_splits)
    if not n_scratch:
        return None, [None] * 3
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=device)
    rows = n_scratch // (dh + 2)
    base = scratch.data_ptr()
    return scratch, [base, base + rows * dh * 4, base + rows * (dh + 1) * 4]


def paged_attention(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over the head-granular paged pool.

    q:            (B, Hkv, r, dh) new-token queries, grouped per kv head,
                  any strides with the last dim contiguous
    kpool/vpool:  (num_slots, page_size, dh) — one layer of the pools, a
                  view into the (L, slots, page, dh) pool (no copy)
    block_tables: (B, Hkv, max_pages) int — entries past the length may be
                  arbitrary ids; they are clipped into range
    lengths:      (B,) int tokens stored per row (0 pads: the output is 0)
    returns       (B, Hkv, r, dh)

    On CUDA tensors bf16 runs both products on the tensor cores and fp32
    on the CUDA cores (never TF32), chosen by dtype alone.
    """
    if q.ndim != 4 or kpool.ndim != 3 or block_tables.ndim != 3:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    B, Hkv, r, dh = q.shape
    slots, page, _ = kpool.shape
    if not q.is_cuda:
        return paged_attention_ref(q, kpool, vpool,
                                   block_tables.clamp(0, slots - 1), lengths)
    _check(q, kpool, vpool, block_tables, lengths)
    if r > SPLIT_ROWS:
        raise ValueError(f"{r} query rows per kv head; the kernel takes "
                         f"at most {SPLIT_ROWS}")
    strides = _q_strides(q)
    fn = _library("paged_attention").paged_attention
    max_pages = block_tables.shape[-1]
    n_splits, span = split_plan(B, Hkv, 1, r, max_pages, page)
    # table entries are clamped into the pool inside the kernel
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, r, dh), dtype=q.dtype, device=q.device)
    scratch, parts = _split_scratch(B, Hkv, 1, r, dh, n_splits, q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 parts[1], parts[2], parts[0], B, Hkv, r, dh, page,
                 max_pages, slots, *strides[:3], n_splits, span,
                 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    LAUNCHES["paged_attention"] += 1
    return out


def split_plan(B: int, Hkv: int, C: int, r: int, max_pages: int,
               page: int) -> Tuple[int, int]:
    """(n_splits, span) of the paged kernels' key axis, from shapes alone
    (no device-to-host read); the decode kernel's is the C = 1 plan.  Only
    where a (row, kv head) has a single query tile of at most
    ``SPLIT_ROWS`` folded rows (decode rows: C * r == r) are its keys cut
    into ``n_splits`` spans of ``span`` keys, a multiple of
    ``SPAN_ALIGN``, so that about ``SPLIT_BLOCKS`` blocks fill the card;
    the spans cover the table's max_pages * page keys once.  Elsewhere one
    span covers the table."""
    S = max_pages * page
    tiles = max(1, -(-S // SPAN_ALIGN))
    if C * r > SPLIT_ROWS or B * Hkv == 0:
        return 1, tiles * SPAN_ALIGN
    n = min(tiles, -(-SPLIT_BLOCKS // (B * Hkv)))
    span = -(-tiles // n) * SPAN_ALIGN
    return max(1, -(-S // span)), span


def prefill_tile(dtype, C: int, r: int, page: int) -> str:
    """The tile a CUDA ``paged_prefill_attention`` launch runs, from its
    dtype and shapes alone (``dispatch_rows`` in the source): ``"split"``
    (one warp a block, keys split into spans) where a (row, kv head) has
    at most ``SPLIT_ROWS`` folded rows; ``"wgmma"`` (the TMA-fed ``wgmma``
    kernel) in bf16 at a page in ``WGMMA_PAGES``; else ``"shared"`` (the
    mma.sync / FMA tile of ``kernels/csrc/attention_tile.cuh``)."""
    if C * r <= SPLIT_ROWS:
        return "split"
    if dtype == torch.bfloat16 and page in WGMMA_PAGES:
        return "wgmma"
    return "shared"


def split_scratch_floats(B: int, Hkv: int, C: int, r: int, dh: int,
                         n_splits: int) -> int:
    """fp32 scratch of a split launch: (m, l, acc) partials, (dh + 2)
    floats per (row, kv head, span, folded query row); none unsplit."""
    return 0 if n_splits == 1 else B * Hkv * n_splits * C * r * (dh + 2)


def paged_prefill_attention(q: torch.Tensor, kpool: torch.Tensor,
                            vpool: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor, starts: torch.Tensor
                            ) -> torch.Tensor:
    """Causal chunk attention over the head-granular paged pool (prefill).

    q:            (B, Hkv, C, r, dh) — one C-token prompt chunk per sequence,
                  queries grouped per kv head, any strides with the last dim
                  contiguous; the chunk's OWN K/V must already be scattered
                  into the pools
    kpool/vpool:  (num_slots, page_size, dh) — one layer of the pools, a
                  view into the (L, slots, page, dh) pool (no copy)
    block_tables: (B, Hkv, max_pages) int — entries past the written length
                  may be arbitrary ids; they are clipped into range
    lengths:      (B,) int keys visible after the chunk's writes (0 pads);
                  what the pools hold past them (non-finite values too)
                  does not reach the output
    starts:       (B,) int absolute position of each chunk's first token
    returns       (B, Hkv, C, r, dh); on CUDA the transposed view of a
                  contiguous (B, C, Hkv, r, dh) tensor

    On CUDA tensors bf16 runs both products on the tensor cores and fp32
    on the CUDA cores (never TF32), the tile chosen by dtype and shapes
    alone (``prefill_tile``).  The wgmma path's K and V tensor maps are
    encoded once per pool view, inside the library.
    """
    if q.ndim != 5 or kpool.ndim != 3 or block_tables.ndim != 3:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    B, Hkv, C, r, dh = q.shape
    slots, page, _ = kpool.shape
    if not q.is_cuda:
        return paged_prefill_attention_ref(q, kpool, vpool,
                                           block_tables.clamp(0, slots - 1),
                                           lengths, starts)
    _check(q, kpool, vpool, block_tables, lengths, starts)
    # q is read through its strides (the model's transposed view is not
    # copied)
    strides = _q_strides(q)
    fn = _library("paged_prefill_attention").paged_prefill_attention
    max_pages = block_tables.shape[-1]
    n_splits, span = split_plan(B, Hkv, C, r, max_pages, page)
    # table entries are clamped into the pool inside the kernel
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    sts = starts.to(torch.int32).contiguous()
    out = torch.empty((B, C, Hkv, r, dh), dtype=q.dtype, device=q.device)
    scratch, parts = _split_scratch(B, Hkv, C, r, dh, n_splits, q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), sts.data_ptr(),
                 out.data_ptr(), parts[1], parts[2], parts[0], B, Hkv, C, r,
                 dh, page, max_pages, slots, *strides[:4], n_splits, span,
                 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["paged_prefill_attention"] += 1
    # (B, Hkv, C, r, dh) view: the caller's transpose back to
    # (B, C, H * dh) is then free
    return out.transpose(1, 2)
