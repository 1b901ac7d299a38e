"""GQA/MHA attention (with qk-norm, qkv-bias and RoPE).  Weights are
``(in, out)``: ``x @ W``.

Two families of attention, as in the reference:

  * against the device-resident paged KV pool (the serving steps): the new
    K/V is scattered in place into the layer's pool, then a paged kernel
    attends through the block tables — the chunked paged-prefill kernel
    for a chunk of rows (the fused step and the split schedule's prefill
    call), the paged decode kernel for one new token per row (the split
    schedule's decode call);
  * against dense per-request caches (the dense oracle modes):
    ``gqa_full`` attends over a whole prompt through the dense
    flash-attention kernel and returns its K/V as cache entries;
    ``gqa_decode`` / ``gqa_decode_carry`` decode one token with the plain
    ``common.decode_attention``.

MLA waits for a later slice (ROADMAP Queue A, item 10).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.common import (DTYPES, apply_rope, decode_attention,
                                       rmsnorm)


def gqa_cache_init(cfg, batch: int, max_seq: int, device) -> Dict:
    """One layer's dense cache: k, v (batch, max_seq, Hkv, dh) zeros in
    the cache storage dtype."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = DTYPES[cfg.kv_dtype]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _gqa_qkv(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
             positions: torch.Tensor):
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_full(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
             positions: torch.Tensor, window: int = 0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (the dense prefill): causal (``cfg.causal``)
    and optionally sliding-window GQA over the whole (B, S) block through
    the dense flash-attention kernel.  Returns (out (B, S, d), cache
    entries k, v (B, S, Hkv, dh) in the cache storage dtype)."""
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    out = fa_ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                 layout="BSHD")
    out = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]
    cdt = DTYPES[cfg.kv_dtype]
    return out, {"k": k.to(cdt), "v": v.to(cdt)}


def gqa_decode(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               window: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode one token per row against one layer's dense cache.

    x: (B, 1, d); cache k, v (B, S, Hkv, dh); pos: (B,) absolute position
    of the new token.  Returns (out (B, 1, d), the updated cache — new
    tensors: the input cache is left as it was)."""
    B = x.shape[0]
    q, k, v = _gqa_qkv(cfg, p, x, pos[:, None])
    bidx, p_ = torch.arange(B, device=x.device), pos.long()
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    k_cache[bidx, p_] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, p_] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                           kv_len=pos + 1, window=window)
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, {"k": k_cache, "v": v_cache}


def gqa_decode_carry(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                     k_full: torch.Tensor, v_full: torch.Tensor, idx: int,
                     pos: torch.Tensor, window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode one token per row against the full stacked dense caches
    (L, B, S, Hkv, dh): the token's K/V is written IN PLACE at
    (idx, b, pos_b) (B*Hkv*dh elements), then layer ``idx`` is attended.
    Returns (out (B, 1, d), k_full, v_full) — the same tensors."""
    B = x.shape[0]
    q, k, v = _gqa_qkv(cfg, p, x, pos[:, None])
    bidx, p_ = torch.arange(B, device=x.device), pos.long()
    k_full[idx, bidx, p_] = k[:, 0].to(k_full.dtype)
    v_full[idx, bidx, p_] = v[:, 0].to(v_full.dtype)
    out = decode_attention(q, k_full[idx].to(q.dtype),
                           v_full[idx].to(q.dtype), kv_len=pos + 1,
                           window=window)
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, k_full, v_full


def gqa_decode_paged(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                     kpool: torch.Tensor, vpool: torch.Tensor, idx: int,
                     block_tables: torch.Tensor, lengths: torch.Tensor,
                     write_slot: torch.Tensor, write_off: torch.Tensor,
                     pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode one new token per row against the paged pools.

    The token's K/V is written IN PLACE into layer ``idx`` of the pools
    (B*Hkv*dh elements), then the paged decode kernel attends through the
    block tables.  Padded rows carry write_slot == sink and lengths == 0,
    so their writes land in the sink slot and their outputs are 0.

    x:            (B, 1, d) new-token hidden states
    kpool/vpool:  (L, slots, page, dh) stacked pools, updated in place
    idx:          layer index into the pool's leading axis
    block_tables: (B, Hkv, max_pages) int slot ids
    lengths:      (B,) int tokens stored INCLUDING the one written here
    write_slot:   (B, Hkv) int slot of the new token's page
    write_off:    (B,) int offset of the new token within its page
    pos:          (B,) int absolute position of the new token (RoPE)
    Returns (out (B, 1, d), kpool, vpool) — the pools are the same tensors.
    """
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _gqa_qkv(cfg, p, x, pos[:, None])
    kl, vl = kpool[idx], vpool[idx]          # views of one layer, no copy
    slots, offs = write_slot.long(), write_off.long()[:, None]
    kl[slots, offs] = k[:, 0].to(kl.dtype)
    vl[slots, offs] = v[:, 0].to(vl.dtype)
    # group-major head fold (H = Hkv * r)
    qg = q[:, 0].reshape(B, Hkv, H // Hkv, dh)
    out = pa_ops.paged_attention(qg, kl.to(q.dtype), vl.to(q.dtype),
                                 block_tables, lengths)
    out = out.reshape(B, 1, H * dh) @ p["wo"]
    return out, kpool, vpool


def gqa_prefill_paged(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                      kpool: torch.Tensor, vpool: torch.Tensor, idx: int,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      starts: torch.Tensor, write_slots: torch.Tensor,
                      write_offs: torch.Tensor, positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attend one (B, C) chunk of rows against the paged pools.

    The chunk's K/V is written IN PLACE into layer ``idx`` of the pools
    (B*C*Hkv*dh elements — no dense cache is materialized), then the
    chunked-prefill kernel attends causally through the block tables.
    Padded rows carry lengths == 0 and padded tokens write to the sink
    slot, so garbage never reaches a real page or a used output.

    x:            (B, C, d) chunk hidden states
    kpool/vpool:  (L, slots, page, dh) stacked pools, updated in place
    idx:          layer index into the pool's leading axis
    block_tables: (B, Hkv, max_pages) int slot ids
    lengths:      (B,) int tokens stored INCLUDING this chunk's writes
    starts:       (B,) int absolute position of each chunk's first token
    write_slots:  (B, Hkv, C) int slot for each chunk token's page
    write_offs:   (B, C) int offset of each chunk token within its page
    positions:    (B, C) int absolute token positions (RoPE)
    Returns (out (B, C, d), kpool, vpool) — the pools are the same tensors.
    """
    B, C, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    kl, vl = kpool[idx], vpool[idx]          # views of one layer, no copy
    slots, offs = write_slots.long(), write_offs.long()[:, None, :]
    kl[slots, offs] = k.transpose(1, 2).to(kl.dtype)
    vl[slots, offs] = v.transpose(1, 2).to(vl.dtype)
    # group-major head fold (H = Hkv * r)
    qg = q.reshape(B, C, Hkv, H // Hkv, dh).transpose(1, 2)
    # ``.to`` is the view itself when the pool holds q's dtype; fp8 pools
    # are upcast as the reference does
    out = pa_ops.paged_prefill_attention(qg, kl.to(q.dtype), vl.to(q.dtype),
                                         block_tables, lengths, starts)
    out = out.transpose(1, 2).reshape(B, C, H * dh) @ p["wo"]
    return out, kpool, vpool
