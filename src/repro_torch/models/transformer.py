"""Model assembly for the paged serving steps.

Parameters are a plain dict mirroring the reference's pytree:
``{"groups": [per-group dict with a leading layer axis], "embed",
"final_norm", "lm_head"}`` (see ``repro_torch.weights``).  Layers run as a
Python loop over the groups; each layer's parameters are views of the
stacked tensors.  Pools are updated in place, but every step still
returns ``(logits, kpools, vpools)`` so the engine reads like the
reference.

The paged steps are ported: the fused step, and the split schedule's
prefill-chunk and decode calls, each over per-device pool shards.
Prefill/decode against dense caches, training and the traced twins wait
for later slices (ROADMAP Queue A, items 7, 8 and 11).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import rmsnorm
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
Pools = Dict[int, torch.Tensor]


def layer_groups(cfg: ModelConfig) -> List[Tuple[str, int, int]]:
    """Ordered (kind, n_layers, window) list of homogeneous layer groups,
    as the reference builds it (its parameter layout follows it)."""
    if cfg.xlstm_pattern:
        period = len(cfg.xlstm_pattern)
        assert cfg.n_layers % period == 0, "xlstm pattern must tile layers"
        return [("xlstm_pair", cfg.n_layers // period, 0)]
    if cfg.attn_type == "none":
        raise ValueError("attention-free non-xlstm archs not supported")

    def window_of(i: int) -> int:
        if not cfg.sliding_window or i in cfg.global_layers:
            return 0
        return cfg.sliding_window

    def kind_of(i: int) -> str:
        if cfg.ssm_state and cfg.attn_type == "gqa":
            return "hybrid"
        a = cfg.attn_type
        if cfg.n_experts and i >= cfg.first_dense_layers:
            return f"{a}_moe"
        return f"{a}_mlp"

    out: List[Tuple[str, int, int]] = []
    for i in range(cfg.n_layers):
        k, w = kind_of(i), window_of(i)
        if out and out[-1][0] == k and out[-1][2] == w:
            out[-1] = (k, out[-1][1] + 1, w)
        else:
            out.append((k, 1, w))
    return out


def _lm_head(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def supports_paged_decode(cfg: ModelConfig) -> bool:
    """Pure-GQA full-attention stacks only; MLA (latent cache), SSM/hybrid
    (recurrent state), xLSTM and sliding-window configs are not paged."""
    return (cfg.attn_type == "gqa" and not cfg.xlstm_pattern
            and not cfg.ssm_state and not cfg.sliding_window
            and not cfg.is_encoder_only)


def supports_paged_prefill(cfg: ModelConfig) -> bool:
    """Chunked paged prefill shares the paged-decode support envelope:
    pure-GQA full-attention stacks with a token embedding frontend."""
    return supports_paged_decode(cfg) and cfg.frontend not in (
        "audio_stub", "vision_stub")


def supports_fused_step(cfg: ModelConfig) -> bool:
    """The fused prefill+decode step needs BOTH paged paths: decode rows
    are degenerate chunks through the chunked-prefill kernel."""
    return supports_paged_decode(cfg) and supports_paged_prefill(cfg)


def _layer_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 attend) -> torch.Tensor:
    """Run every layer on ``x``: rmsnorm, ``attend(p_attn, xn, idx)`` (the
    attention output; it writes layer ``idx`` of the pools), residual,
    rmsnorm, MLP, residual.  Returns the final-normed hidden states."""
    layer0 = 0
    for gi, (kind, n, _win) in enumerate(layer_groups(cfg)):
        if kind != "gqa_mlp":
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported (ROADMAP Queue A, "
                f"item 2: moe_apply; item 10: other model families)")
        gp = params["groups"][gi]
        for li in range(n):
            xn = rmsnorm(x, gp["attn_norm"][li], cfg.norm_eps)
            x = x + attend({k: v[li] for k, v in gp["attn"].items()}, xn,
                           layer0 + li)
            if "mlp" in gp:
                xn = rmsnorm(x, gp["mlp_norm"][li], cfg.norm_eps)
                x = x + mlp_mod.mlp_apply(
                    cfg, {k: v[li] for k, v in gp["mlp"].items()}, xn)
        layer0 += n
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _paged_chunk_forward(cfg: ModelConfig, params: Params,
                         kpool: torch.Tensor, vpool: torch.Tensor,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         starts: torch.Tensor, write_slots: torch.Tensor,
                         write_offs: torch.Tensor, tokens: torch.Tensor,
                         last_idx: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Embed a (B, C) token block, and per layer: rmsnorm, attention
    (K/V scattered into the pools, paged chunk kernel), MLP.  Returns
    each row's last-valid-token logits (fp32) and the pools."""
    C = tokens.shape[1]
    positions = starts.long()[:, None] \
        + torch.arange(C, device=tokens.device)[None, :]

    def attend(p_attn, xn, idx):
        return attn.gqa_prefill_paged(
            cfg, p_attn, xn, kpool, vpool, idx, block_tables, lengths,
            starts, write_slots, write_offs, positions)[0]

    h = _layer_stack(cfg, params, params["embed"][tokens.long()], attend)
    last = h[torch.arange(h.shape[0], device=h.device), last_idx.long()]
    logits = (last @ _lm_head(cfg, params)).float()
    return logits, kpool, vpool


def paged_decode_step(cfg: ModelConfig, params: Params,
                      kpool: torch.Tensor, vpool: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      write_slot: torch.Tensor, write_off: torch.Tensor,
                      tokens: torch.Tensor, pos: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against the paged KV pools: per layer the new
    token's K/V is written in place (one (B*Hkv)-element scatter) and the
    paged decode kernel attends through the block tables.

    tokens: (B, 1) int; pos: (B,) absolute position of each new token;
    other operands documented in ``attn.gqa_decode_paged``.
    Returns (logits (B, vocab) fp32, kpool, vpool)."""
    assert supports_paged_decode(cfg), "config not supported by paged decode"

    def attend(p_attn, xn, idx):
        return attn.gqa_decode_paged(
            cfg, p_attn, xn, kpool, vpool, idx, block_tables, lengths,
            write_slot, write_off, pos)[0]

    h = _layer_stack(cfg, params, params["embed"][tokens.long()], attend)
    logits = (h[:, 0] @ _lm_head(cfg, params)).float()
    return logits, kpool, vpool


def paged_prefill_chunk(cfg: ModelConfig, params: Params,
                        kpool: torch.Tensor, vpool: torch.Tensor,
                        block_tables: torch.Tensor, lengths: torch.Tensor,
                        starts: torch.Tensor, write_slots: torch.Tensor,
                        write_offs: torch.Tensor, tokens: torch.Tensor,
                        last_idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill one (B, C) chunk of prompt tokens against the paged pools
    (the split schedule's prefill call): K/V scattered in place, the
    chunked-prefill kernel attends causally through the block tables.

    tokens:   (B, C) int chunk tokens (0-padded rows/tails)
    starts:   (B,) absolute position of tokens[:, 0]
    lengths:  (B,) tokens stored after this chunk's writes (0 pads rows)
    last_idx: (B,) in-chunk index of each row's last valid token
    Returns (last-token logits (B, vocab), kpool, vpool)."""
    assert supports_paged_prefill(cfg), \
        "config not supported by paged prefill"
    return _paged_chunk_forward(cfg, params, kpool, vpool, block_tables,
                                lengths, starts, write_slots, write_offs,
                                tokens, last_idx)


def paged_fused_step(cfg: ModelConfig, params: Params,
                     kpool: torch.Tensor, vpool: torch.Tensor,
                     block_tables: torch.Tensor, lengths: torch.Tensor,
                     starts: torch.Tensor, write_slots: torch.Tensor,
                     write_offs: torch.Tensor, tokens: torch.Tensor,
                     last_idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE model call serving a mixed prefill+decode row batch.

    The row batch (B, C) packs two kinds of rows, told apart only by their
    per-row scalars — the kernel never branches on row kind:

      * **decode rows** — the degenerate chunk: one valid token (the last
        generated one) at ``starts[i] == ctx - 1``, ``lengths[i] == ctx``,
        ``last_idx[i] == 0``;
      * **prefill rows** — a ≤C-token prompt chunk.

    Padded rows carry ``lengths == 0`` and write to the sink slot.
    Returns (last-valid-token logits (B, vocab), kpool, vpool).
    """
    assert supports_fused_step(cfg), "config not supported by fused step"
    return _paged_chunk_forward(cfg, params, kpool, vpool, block_tables,
                                lengths, starts, write_slots, write_offs,
                                tokens, last_idx)


def _pool_exchange_in(kpools: Pools, vpools: Pools, anchor: int,
                      anchor_sink: int, g_dev: torch.Tensor,
                      g_src: torch.Tensor, g_dst: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather remote pages into the anchor pool's staging region, in place.

    The paged kernel reads ONE pool pair, so rows whose pages live in
    another device's pool shard are served by copying those pages into
    the anchor's staging slots first.  ``g_dev/g_src/g_dst`` are
    bucket-padded lane arrays (``PoolStepPlan.exchange_arrays``); lanes of
    other devices degrade to sink-to-sink copies (the remote sink read,
    the anchor sink written — both garbage by construction, never read
    through a length mask).  Zero lanes skip the copies.
    Returns the anchor (kpool, vpool)."""
    ak, av = kpools[anchor], vpools[anchor]
    if g_dev.shape[0] == 0:
        return ak, av
    for dev in sorted(d for d in kpools if d != anchor):
        kp, vp = kpools[dev], vpools[dev]
        rsink = kp.shape[1] - 1
        m = g_dev == dev
        src = torch.where(m, g_src, rsink).long()
        dst = torch.where(m, g_dst, anchor_sink).long()
        ak[:, dst] = kp[:, src]
        av[:, dst] = vp[:, src]
    return ak, av


def _pool_exchange_out(kpools: Pools, vpools: Pools, anchor: int,
                       anchor_sink: int, w_dev: torch.Tensor,
                       w_src: torch.Tensor, w_dst: torch.Tensor
                       ) -> Tuple[Pools, Pools]:
    """Write dirty staged pages back to their owning pool shards, in
    place — the inverse of ``_pool_exchange_in``.  Masked lanes write the
    remote pool's own sink from the anchor's sink."""
    if w_dev.shape[0] == 0:
        return kpools, vpools
    ak, av = kpools[anchor], vpools[anchor]
    for dev in sorted(d for d in kpools if d != anchor):
        kp, vp = kpools[dev], vpools[dev]
        rsink = kp.shape[1] - 1
        m = w_dev == dev
        src = torch.where(m, w_src, anchor_sink).long()
        dst = torch.where(m, w_dst, rsink).long()
        kp[:, dst] = ak[:, src]
        vp[:, dst] = av[:, src]
    return kpools, vpools


def _on_anchor(kpools: Pools, vpools: Pools, anchor: int,
               anchor_sink: int, exchange, step):
    """Run ``step(anchor kpool, anchor vpool) -> logits`` over per-device
    pool shards: stage remote pages into the anchor pool, run the
    single-pool step on it, write dirty staged pages back.  ``exchange``
    is ``(g_dev, g_src, g_dst, w_dev, w_src, w_dst)``.
    Returns (logits, kpools, vpools); the pools are updated in place."""
    g_dev, g_src, g_dst, w_dev, w_src, w_dst = exchange
    ak, av = _pool_exchange_in(kpools, vpools, anchor, anchor_sink,
                               g_dev, g_src, g_dst)
    logits = step(ak, av)
    kpools, vpools = _pool_exchange_out(kpools, vpools, anchor, anchor_sink,
                                        w_dev, w_src, w_dst)
    return logits, kpools, vpools


def sharded_fused_step(cfg: ModelConfig, params: Params,
                       kpools: Pools, vpools: Pools, anchor: int,
                       anchor_sink: int, g_dev, g_src, g_dst, w_dev, w_src,
                       w_dst, block_tables, lengths, starts, write_slots,
                       write_offs, tokens, last_idx):
    """``paged_fused_step`` over per-device pool shards.  Block tables and
    write slots are ANCHOR-pool indices built by ``PoolStepPlan``.
    Returns (logits, kpools, vpools); the pools are updated in place."""
    assert supports_fused_step(cfg), "config not supported by fused step"
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_fused_step(
            cfg, params, ak, av, block_tables, lengths, starts, write_slots,
            write_offs, tokens, last_idx)[0])


def sharded_decode_step(cfg: ModelConfig, params: Params,
                        kpools: Pools, vpools: Pools, anchor: int,
                        anchor_sink: int, g_dev, g_src, g_dst, w_dev, w_src,
                        w_dst, block_tables, lengths, write_slot, write_off,
                        tokens, pos):
    """``paged_decode_step`` over per-device pool shards; the writeback
    lanes carry the remote rows' decode-token page back to its shard.
    Returns (logits, kpools, vpools); the pools are updated in place."""
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_decode_step(
            cfg, params, ak, av, block_tables, lengths, write_slot,
            write_off, tokens, pos)[0])


def sharded_prefill_chunk(cfg: ModelConfig, params: Params,
                          kpools: Pools, vpools: Pools, anchor: int,
                          anchor_sink: int, g_dev, g_src, g_dst, w_dev,
                          w_src, w_dst, block_tables, lengths, starts,
                          write_slots, write_offs, tokens, last_idx):
    """``paged_prefill_chunk`` over per-device pool shards.
    Returns (logits, kpools, vpools); the pools are updated in place."""
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_prefill_chunk(
            cfg, params, ak, av, block_tables, lengths, starts, write_slots,
            write_offs, tokens, last_idx)[0])
