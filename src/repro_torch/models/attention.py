"""GQA/MHA attention (with qk-norm, qkv-bias, RoPE and sliding windows)
and MLA (deepseek-v3's latent attention).  Weights are ``(in, out)``:
``x @ W``.

Two families of GQA attention, as in the reference:

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

MLA runs against dense latent caches only, as in the reference: the
prefill (``mla_full``) materialises per-head K (dim qk_nope + qk_rope) and
V (dim v_head_dim) from the latent and attends through the dense
flash-attention kernel at those two widths; decode (``mla_decode``,
``mla_decode_carry``) absorbs the up-projections into the query and the
output and attends against the latent cache ``ckv`` (B, S, kv_lora_rank)
and ``krope`` (B, S, qk_rope) with plain products, per-head K/V never
formed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.common import (DTYPES, NEG_INF, apply_rope, cdtype,
                                       decode_attention, rmsnorm)


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


# ---------------------------------------------------------------- MLA
def mla_cache_init(cfg, batch: int, max_seq: int, device) -> Dict:
    """One layer's latent cache: ckv (batch, max_seq, kv_lora_rank) and
    krope (batch, max_seq, qk_rope_head_dim) zeros in the compute dtype."""
    dt = cdtype(cfg)
    return {"ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                               dtype=dt, device=device),
            "krope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                                 dtype=dt, device=device)}


def _mla_q(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
           positions: torch.Tensor):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr)) through the query's
    low-rank path."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(B, S, cfg.n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor):
    """(ckv (B, S, kv_lora_rank) normalised, krope (B, S, dr) rotated)."""
    c = cfg.kv_lora_rank
    ckv_kr = x @ p["wdkv"]
    ckv = rmsnorm(ckv_kr[..., :c], p["kv_norm"], cfg.norm_eps)
    krope = apply_rope(ckv_kr[..., c:][:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]
    return ckv, krope


def mla_full(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
             positions: torch.Tensor, window: int = 0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The prefill, not absorbed: per-head K = [k_nope, krope broadcast
    over heads] (dim dn + dr) and V (dim dv) from the latent, then the
    dense flash-attention kernel at (dn + dr, dv), scaled by
    1/sqrt(dn + dr).  Returns (out (B, S, d), the latent cache entries
    ckv, krope)."""
    B, S, _ = x.shape
    H, c = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, krope = _mla_latent(cfg, p, x, positions)
    k_nope = (ckv @ p["wuk"].reshape(c, H * dn)).view(B, S, H, dn)
    v = (ckv @ p["wuv"].reshape(c, H * dv)).view(B, S, H, dv)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = fa_ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                 layout="BSHD")
    out = out.reshape(B, S, H * dv) @ p["wo"]
    return out, {"ckv": ckv, "krope": krope}


def _mla_absorbed(cfg, p: Dict[str, torch.Tensor], q_nope: torch.Tensor,
                  q_rope: torch.Tensor, ckv: torch.Tensor,
                  krope: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token attention against a layer's latent cache with the
    up-projections absorbed: scores in fp32 over the keys below pos + 1,
    the weights rounded to the cache's dtype before the latent product."""
    B = q_nope.shape[0]
    q_abs = torch.einsum("bqhd,chd->bqhc", q_nope, p["wuk"])
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    s_nope = torch.einsum("bqhc,bsc->bhqs", q_abs.float(), ckv.float())
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.float(), krope.float())
    scores = (s_nope + s_rope) * scale
    k_pos = torch.arange(ckv.shape[1], device=ckv.device)[None, :]
    valid = k_pos < (pos.long() + 1)[:, None]
    scores = scores + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    w = torch.softmax(scores, dim=-1).to(ckv.dtype)
    out_lat = torch.einsum("bhqs,bsc->bqhc", w, ckv)
    out = torch.einsum("bqhc,chd->bqhd", out_lat, p["wuv"])
    return out.reshape(B, 1, -1) @ p["wo"]


def mla_decode(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               window: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed decode of one token per row against one layer's latent
    cache.  x: (B, 1, d); pos: (B,).  Returns (out (B, 1, d), the updated
    cache — new tensors: the input cache is left as it was).  The
    reference's MLA decode takes no window, nor does this."""
    B = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])
    ckv_new, krope_new = _mla_latent(cfg, p, x, pos[:, None])
    bidx, p_ = torch.arange(B, device=x.device), pos.long()
    ckv, krope = cache["ckv"].clone(), cache["krope"].clone()
    ckv[bidx, p_] = ckv_new[:, 0]
    krope[bidx, p_] = krope_new[:, 0]
    out = _mla_absorbed(cfg, p, q_nope, q_rope, ckv, krope, pos)
    return out, {"ckv": ckv, "krope": krope}


def mla_decode_carry(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                     ckv_full: torch.Tensor, krope_full: torch.Tensor,
                     idx: int, pos: torch.Tensor, window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed decode against the full stacked latent caches (L, B, S,
    c): the token's latent is written IN PLACE at (idx, b, pos_b), then
    layer ``idx`` is attended.  Returns (out (B, 1, d), ckv_full,
    krope_full) — the same tensors."""
    B = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])
    ckv_new, krope_new = _mla_latent(cfg, p, x, pos[:, None])
    bidx, p_ = torch.arange(B, device=x.device), pos.long()
    ckv_full[idx, bidx, p_] = ckv_new[:, 0]
    krope_full[idx, bidx, p_] = krope_new[:, 0]
    out = _mla_absorbed(cfg, p, q_nope, q_rope, ckv_full[idx],
                        krope_full[idx], pos)
    return out, ckv_full, krope_full
