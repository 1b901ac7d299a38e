"""Plain PyTorch versions of the paged-attention kernels: gather the pages
into dense K/V, then exact masked softmax attention.  The CPU paths of
``ops.paged_attention`` and ``ops.paged_prefill_attention`` and the
oracles the CUDA kernels are held against on the card."""

from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, kpool: torch.Tensor,
                        vpool: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q:            (B, Hkv, r, dh) — one new token per sequence, grouped
    kpool/vpool:  (num_slots, page, dh)
    block_tables: (B, Hkv, max_pages) int slot ids, all in range
    lengths:      (B,) int tokens stored per sequence (0 pads)
    returns       (B, Hkv, r, dh)
    """
    B, Hkv, r, dh = q.shape
    page = kpool.shape[1]
    S = block_tables.shape[-1] * page
    bt = block_tables.long()

    K = kpool[bt].reshape(B, Hkv, S, dh)
    V = vpool[bt].reshape(B, Hkv, S, dh)

    s = torch.einsum("bhrd,bhkd->bhrk", q.float(), K.float()) / math.sqrt(dh)
    valid = torch.arange(S, device=q.device)[None, :] \
        < lengths.long()[:, None]                           # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)        # rows that see no key
    out = torch.einsum("bhrk,bhkd->bhrd", w, V.float())
    return out.to(q.dtype)


def paged_prefill_attention_ref(q: torch.Tensor, kpool: torch.Tensor,
                                vpool: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor, starts: torch.Tensor
                                ) -> torch.Tensor:
    """q:            (B, Hkv, C, r, dh) — one prompt chunk per sequence
    kpool/vpool:  (num_slots, page, dh)
    block_tables: (B, Hkv, max_pages) int slot ids, all in range
    lengths:      (B,) int keys visible after the chunk's writes (0 pads)
    starts:       (B,) int absolute position of q[:, :, 0]
    returns       (B, Hkv, C, r, dh)
    """
    B, Hkv, C, r, dh = q.shape
    page = kpool.shape[1]
    max_pages = block_tables.shape[-1]
    S = max_pages * page
    bt = block_tables.long()

    K = kpool[bt].reshape(B, Hkv, S, dh)
    V = vpool[bt].reshape(B, Hkv, S, dh)

    s = torch.einsum("bhcrd,bhkd->bhcrk", q.float(), K.float()) \
        / math.sqrt(dh)
    k_pos = torch.arange(S, device=q.device)
    q_pos = starts.long()[:, None] + torch.arange(C, device=q.device)[None]
    ok = (k_pos[None, None, :] <= q_pos[:, :, None]) \
        & (k_pos[None, None, :] < lengths.long()[:, None, None])  # (B, C, S)
    s = s.masked_fill(~ok[:, None, :, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)        # rows that see no key
    out = torch.einsum("bhcrk,bhkd->bhcrd", w, V.float())
    return out.to(q.dtype)
