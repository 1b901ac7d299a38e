"""Public wrappers of the paged-attention kernels.

  paged_attention          — decode attention, one new token per row
                             (``csrc/paged_attention.cu``; the split
                             schedule's decode call): in bf16 at a page in
                             WGMMA_PAGES and r > 1 the TMA-fed decode tile
                             (``csrc/paged_decode_tma.cuh``), elsewhere the
                             one-warp split tile (``decode_tile``)
  paged_prefill_attention  — causal chunk attention
                             (``csrc/paged_prefill_attention.cu``; the fused
                             step and the split schedule's prefill call):
                             in bf16 at a page in WGMMA_PAGES the decode
                             tile where a (row, kv head) has at most
                             SPLIT_ROWS folded rows and r > 1, and a
                             TMA-fed wgmma kernel past them, elsewhere the
                             shared mma.sync / FMA tile (``launch_tile``)

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
# pages the TMA-fed kernels (B1's wgmma path, the decode tile) read as
# boxes: a 64-key tile in boxes of whole 1024-byte swizzle groups
WGMMA_PAGES = (8, 16, 32, 64)
# the decode tile's 64-key tiles, and its persistent grid: blocks an SM
# (kBlocksPerSm in csrc/paged_decode_tma.cuh)
TMA_KEYS = 64
TMA_BLOCKS_PER_SM = 2
# the split's weight of a (row, kv head)'s fixed cost, in tiles
# (kHeadCost)
TMA_HEAD_COST = 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far, per wrapper (a run resets them to 0 and reads
# them back to show that its path went through the kernels)
LAUNCHES = {"paged_attention": 0, "paged_prefill_attention": 0}
# paged_prefill_attention's launches by the tile they ran (``launch_tile``)
PREFILL_TILE_LAUNCHES = {"tma": 0, "warp": 0, "wgmma": 0, "shared": 0}


# C signatures: tensor pointers, int sizes, then scale, dtype and stream
_ARGTYPES = {
    "paged_attention": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3,
    "paged_prefill_attention": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3,
}
# the decode tile's tickets: int32 zeros, one per (row, kv head), kept per
# (device, stream) -- each launch leaves them zero, and launches on one
# stream run in turn -- and the SM count of each device.  Tickets are never
# freed: a captured CUDA graph holds the address it was captured with
# (``_RETIRED`` keeps those a larger batch replaced).
_TICKETS: dict = {}
_RETIRED: list = []
_SMS: dict = {}


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
    others 16-byte multiples, and q's start 16-byte aligned (the decode
    tile copies its rows whole)."""
    strides = [0 if n == 1 else st for n, st in zip(q.shape, q.stride())]
    if strides[-1] not in (0, 1) or any(st * q.element_size() % 16
                                        for st in strides[:-1]):
        raise ValueError(f"q strides {tuple(q.stride())}: the last dim must "
                         f"be contiguous and the others 16-byte multiples")
    if q.data_ptr() % 16:
        raise ValueError("q must start on a 16-byte boundary")
    return strides


def _split_scratch(n_scratch: int, dh: int, device
                   ) -> Tuple[Optional[torch.Tensor], list]:
    """``n_scratch`` floats of fp32 scratch ((dh + 2) a partial row) and
    pointers to its (acc, m, l) partials in it; (None, null pointers)
    where there are none.  The caller holds the tensor until the launch
    is enqueued."""
    if not n_scratch:
        return None, [None] * 3
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=device)
    rows = n_scratch // (dh + 2)
    base = scratch.data_ptr()
    return scratch, [base, base + rows * dh * 4, base + rows * (dh + 1) * 4]


def tma_blocks(device) -> int:
    """The decode tile's grid on ``device``: TMA_BLOCKS_PER_SM blocks on
    each of its SMs (read once per device)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return TMA_BLOCKS_PER_SM * _SMS[idx]


def _tickets(n: int, device, stream: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the decode tile's tickets on
    ``stream`` of ``device``, grown (zeroed anew) as batches grow."""
    key = (torch.device(device).index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # made under a capture they would live in the graph's pool
            raise RuntimeError(
                "the decode tile's tickets must exist before a CUDA graph "
                "capture: run the call once on the capture stream first")
        if t is not None:
            _RETIRED.append(t)
        t = torch.zeros(max(n, 256, 0 if t is None else 2 * t.numel()),
                        dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _launch_plan(dtype, B: int, Hkv: int, C: int, r: int, dh: int,
                 max_pages: int, page: int, device, stream: int):
    """(n_splits, span, n_blocks, scratch, parts, tickets) of a launch:
    the decode tile's grid, its 2 n_blocks pieces of scratch and its
    tickets where it runs (``launch_tile``), else the split plan's spans
    and scratch.  The caller holds the tensors until the launch is
    enqueued."""
    if launch_tile(dtype, C, r, page) == "tma":
        n_blocks = tma_blocks(device)
        scratch, parts = _split_scratch(
            tma_scratch_floats(n_blocks, C * r, dh), dh, device)
        tickets = _tickets(B * Hkv, device, stream)
        span = max(1, -(-max_pages * page // SPAN_ALIGN)) * SPAN_ALIGN
        return 1, span, n_blocks, scratch, parts, tickets
    n_splits, span = split_plan(B, Hkv, C, r, max_pages, page)
    scratch, parts = _split_scratch(
        split_scratch_floats(B, Hkv, C, r, dh, n_splits), dh, device)
    return n_splits, span, 0, scratch, parts, None


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
    lengths:      (B,) int tokens stored per row (0 pads: the output is 0);
                  what the pools hold past them (non-finite values too)
                  does not reach the output
    returns       (B, Hkv, r, dh)

    On CUDA tensors bf16 runs both products on the tensor cores and fp32
    on the CUDA cores (never TF32); the kernel is chosen by dtype, page and
    r alone (``decode_tile``).
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_splits, span, n_blocks, scratch, parts, tickets = _launch_plan(
        q.dtype, B, Hkv, 1, r, dh, max_pages, page, q.device, stream)
    # table entries are clamped into the pool inside the kernel
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, r, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 parts[1], parts[2], parts[0],
                 None if tickets is None else tickets.data_ptr(), B, Hkv, r,
                 dh, page, max_pages, slots, *strides[:3], n_splits, span,
                 n_blocks, 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], stream)
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
    (a (row, kv head)'s keys split across blocks: ``decode_tile`` says by
    which kernel) where a (row, kv head) has at most ``SPLIT_ROWS`` folded
    rows; ``"wgmma"`` (the TMA-fed ``wgmma`` kernel) in bf16 at a page in
    ``WGMMA_PAGES``; else ``"shared"`` (the mma.sync / FMA tile of
    ``kernels/csrc/attention_tile.cuh``)."""
    if C * r <= SPLIT_ROWS:
        return "split"
    if dtype == torch.bfloat16 and page in WGMMA_PAGES:
        return "wgmma"
    return "shared"


def decode_tile(dtype, page: int, r: int) -> str:
    """The kernel of every CUDA ``paged_attention`` launch and of the
    ``paged_prefill_attention`` launches ``prefill_tile`` calls
    ``"split"``, from dtype and shapes alone (``decode_tile_takes``,
    ``dispatch_tile`` and ``dispatch_rows`` in the sources): ``"tma"`` (the
    TMA-fed decode tile of ``csrc/paged_decode_tma.cuh``: the live key
    tiles split over a persistent grid by ``tma_plan``, merged in the same
    launch) in bf16 at a page in ``WGMMA_PAGES`` with ``r`` > 1 query rows
    a kv head; else ``"warp"`` (the one-warp split tile, spans from
    ``split_plan``, merged by a second kernel), which MHA (r = 1) keeps:
    it measured faster there."""
    return "tma" if dtype == torch.bfloat16 and page in WGMMA_PAGES \
        and r > 1 else "warp"


def launch_tile(dtype, C: int, r: int, page: int) -> str:
    """The kernel a CUDA ``paged_prefill_attention`` launch runs:
    ``decode_tile`` where ``prefill_tile`` is ``"split"``, else
    ``prefill_tile``."""
    tile = prefill_tile(dtype, C, r, page)
    return decode_tile(dtype, page, r) if tile == "split" else tile


def tma_row_tiles(lengths, starts, C: int, max_pages: int,
                  page: int) -> list:
    """The decode tile's walk of each row (each of its (row, kv head)s):
    64-key tiles up to its last folded row's end, min(length, start + C)
    (``starts`` None in decode: the length), lengths clamped to the
    table.  The device computes the same (``row_tiles``)."""
    tiles = []
    for b, n in enumerate(lengths):
        keys = max(0, min(int(n), max_pages * page))
        if starts is not None:
            keys = max(0, min(keys, int(starts[b]) + C))
        tiles.append(-(-keys // TMA_KEYS))
    return tiles


def tma_block_start(g: int, U: int, G: int) -> int:
    """The first unit of block g of G over U units (``block_start``)."""
    return g * U // G


def tma_block_of(u: int, U: int, G: int) -> int:
    """The block whose units hold unit u (``block_of``)."""
    g = u * G // U
    while g + 1 < G and tma_block_start(g + 1, U, G) <= u:
        g += 1
    while tma_block_start(g, U, G) > u:
        g -= 1
    return g


def tma_head_units(row_tiles, Hkv: int) -> dict:
    """{(b, h): first unit} of each (row, kv head) with tiles: its
    TMA_HEAD_COST units of fixed cost come first, then a unit a tile, in
    (row, kv head) order."""
    units, base = {}, 0
    for b, nt in enumerate(row_tiles):
        for h in range(Hkv if nt else 0):
            units[(b, h)] = base
            base += nt + TMA_HEAD_COST
    return units


def tma_plan(row_tiles, Hkv: int, n_blocks: int):
    """The decode tile's work split, as every block computes it on the
    card: (U, G, walks).  Each (row, kv head) with tiles weighs its tiles
    plus TMA_HEAD_COST (``tma_head_units``); G = min(n_blocks, U) blocks
    split the U units, block g walking the tiles whose units lie in [g U /
    G, (g + 1) U / G) (blocks past G, or whose units hold no tile, only
    write zero rows).  ``walks[g]`` lists the block's segments (b, h,
    first tile, end tile, slot): slot None where the block covers the
    (row, kv head) and writes its output, else the slot of its fp32
    partials, 2 g for the block's first segment and 2 g + 1 for its
    last."""
    units = tma_head_units(row_tiles, Hkv)
    U = len(units) * TMA_HEAD_COST + Hkv * sum(row_tiles)
    G = min(n_blocks, U)
    walks = []
    for g in range(G):
        u0, u1 = tma_block_start(g, U, G), tma_block_start(g + 1, U, G)
        segs = []
        for (b, h), ub in units.items():
            nt = row_tiles[b]
            first = ub + TMA_HEAD_COST          # tile 0's unit
            t0, t1 = max(u0, first) - first, min(u1, first + nt) - first
            if t0 >= t1:
                continue
            covered = t0 == 0 and t1 == nt
            segs.append((b, h, t0, t1,
                         None if covered else 2 * g + (len(segs) > 0)))
        walks.append(segs)
    return U, G, walks


def tma_pieces(ub: int, nt: int, U: int, G: int) -> list:
    """The slots of the partials of the (row, kv head) whose first unit is
    ub and that has nt tiles, in span order, as the block that takes its
    last ticket reads them (``merge_pieces``)."""
    first = ub + TMA_HEAD_COST
    ga, gb = tma_block_of(first, U, G), tma_block_of(first + nt - 1, U, G)
    return [2 * g + (g == ga and tma_block_start(ga, U, G) < ub)
            for g in range(ga, gb + 1)]


def tma_scratch_floats(n_blocks: int, M: int, dh: int) -> int:
    """fp32 scratch of a decode-tile launch: (m, l, acc) partials, (dh +
    2) floats per folded row of 2 n_blocks pieces (each block's first and
    last segment), from shapes alone."""
    return 2 * n_blocks * M * (dh + 2)


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
    alone (``launch_tile``).  The TMA-fed kernels' K and V tensor maps are
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_splits, span, n_blocks, scratch, parts, tickets = _launch_plan(
        q.dtype, B, Hkv, C, r, dh, max_pages, page, q.device, stream)
    # table entries are clamped into the pool inside the kernel
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    sts = starts.to(torch.int32).contiguous()
    out = torch.empty((B, C, Hkv, r, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), sts.data_ptr(),
                 out.data_ptr(), parts[1], parts[2], parts[0],
                 None if tickets is None else tickets.data_ptr(), B, Hkv, C,
                 r, dh, page, max_pages, slots, *strides[:4], n_splits, span,
                 n_blocks, 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["paged_prefill_attention"] += 1
    PREFILL_TILE_LAUNCHES[launch_tile(q.dtype, C, r, page)] += 1
    # (B, Hkv, C, r, dh) view: the caller's transpose back to
    # (B, C, H * dh) is then free
    return out.transpose(1, 2)
