"""Model assembly for the serving steps and the model functions.

Parameters are a plain dict mirroring the reference's pytree:
``{"groups": [per-group dict with a leading layer axis], "embed",
"final_norm", "lm_head"}`` (plus ``in_proj``/``pos_embed`` for the audio
stub and ``img_proj`` for the vision stub; see ``repro_torch.weights``).
Every forward pass runs the one layer loop ``_layer_stack`` (the
reference's scanned ``backbone`` / ``_apply_full`` / ``_apply_decode*``
bodies); what differs is the attention and the recurrent-block step each
pass hands it.  Pools are updated in place, but every paged step still
returns ``(logits, kpools, vpools)`` so the engine reads like the
reference.

Layer kinds (``layer_groups``): ``gqa_mlp`` / ``gqa_moe``; ``mla_mlp`` /
``mla_moe`` (deepseek-v3's latent attention); ``hybrid`` (hymba:
attention and an SSM in parallel on the same input, each through its own
rmsnorm, mean-fused); ``xlstm_pair`` (an mLSTM then an sLSTM block, each
with its own residual).

Ported: the paged steps (the fused step, and the split schedule's
prefill-chunk and decode calls, each over per-device pool shards), for
pure-GQA full-attention stacks with a token frontend; and the dense model
functions for every kind and frontend — ``prefill`` (attention through
the flash-attention kernel), ``decode_step`` against dense caches
("carry" and "stacked") and ``forward_hidden`` (the encoder's entry
point).  The paged steps' traced twins (``*_traced``, the engine's
per-module probe) run the same layer loop with a tracer: one
device-synchronised span per module (``embed``, ``attention`` per layer,
``mlp`` per layer, ``lm_head`` with the final rmsnorm), so the untraced
calls run the same operations in the same order.  Training:
``loss_fn`` (the chunked cross-entropy over ``forward_hidden``, each layer
under activation checkpointing with ``cfg.remat``), differentiated by
autograd, the attention through the flash-attention kernel's backward on
the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.device import resolve
from repro_torch.models.common import cdtype, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry.tracer import Tracer

Params = Dict[str, Any]
Cache = Dict[str, Any]
Pools = Dict[int, torch.Tensor]
# the untraced calls' tracer: its spans and syncs are no-ops
_UNTRACED = Tracer(enabled=False)
# the recurrent blocks: full-sequence and one-token steps, where a group's
# cache holds each block's state (None: the group's own dict) and its keys
_RECURRENT = {
    "ssm": (ssm_mod.ssm_forward, ssm_mod.ssm_decode, None, ("conv", "ssm")),
    "mlstm": (xlstm_mod.mlstm_forward, xlstm_mod.mlstm_decode, "m",
              ("C", "n", "m")),
    "slstm": (xlstm_mod.slstm_forward, xlstm_mod.slstm_decode, "s",
              ("c", "n", "h", "m")),
}


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


def _layer_slots(cfg: ModelConfig) -> List[Tuple[str, int, int, int]]:
    """(kind, group, index within the group, attention window) of every
    layer, in order."""
    return [(kind, gi, li, win) for gi, (kind, n, win)
            in enumerate(layer_groups(cfg)) for li in range(n)]


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                 dev: torch.device) -> Cache:
    if kind == "xlstm_pair":
        return {"m": xlstm_mod.mlstm_cache_init(cfg, batch, dev),
                "s": xlstm_mod.slstm_cache_init(cfg, batch, dev)}
    if kind.startswith("mla"):
        c = attn.mla_cache_init(cfg, batch, max_seq, dev)
    else:
        c = attn.gqa_cache_init(cfg, batch, max_seq, dev)
    if kind == "hybrid":
        c.update(ssm_mod.ssm_cache_init(cfg, batch, dev))
    return c


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Cache:
    """Dense decode caches: ``{"groups": [per-group cache, every leaf with
    a leading layer axis], "pos": (batch,) int32}``.  A group's cache by
    kind: attention ``k``, ``v`` (n, batch, max_seq, Hkv, dh); MLA
    ``ckv``, ``krope`` (n, batch, max_seq, c / dr); hybrid both ``k``,
    ``v`` and the SSM's ``conv``, ``ssm``; xLSTM ``m`` (mLSTM: ``C``,
    ``n``, ``m``) and ``s`` (sLSTM: ``c``, ``n``, ``h``, ``m``)."""
    dev = resolve(device)
    groups = []
    for kind, n, _win in layer_groups(cfg):
        one = _layer_cache(cfg, kind, batch, max_seq, dev)
        groups.append(_map(one, lambda v: v[None].repeat(
            (n,) + (1,) * v.ndim)))
    return {"groups": groups,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict
                 ) -> torch.Tensor:
    """Raw model inputs -> the (B, S, d) hidden-state stream.  Text: a
    token embedding lookup of ``tokens``; audio stub: ``frames`` (B, S, d)
    @ ``in_proj`` plus the learned positions; vision stub: ``image_embeds``
    (B, P, d) @ ``img_proj`` put in front of the token embeddings, so
    positions count the prefix."""
    dt = cdtype(cfg)
    if cfg.frontend == "audio_stub":
        x = batch["frames"].to(dt) @ params["in_proj"]
        if cfg.max_pos_embed:
            x = x + params["pos_embed"][None, :x.shape[1]]
        return x
    tok = params["embed"][batch["tokens"].long()]
    if cfg.frontend == "vision_stub":
        img = batch["image_embeds"].to(dt) @ params["img_proj"]
        return torch.cat([img, tok], dim=1)
    return tok


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


def _layer_params(tree: Params) -> List[Params]:
    """A group's stacked parameters (every leaf with a leading layer axis;
    nested dicts, such as the MoE layer's shared experts, included) as one
    tree of views per layer: one ``unbind`` per leaf, whose backward
    stacks the layers' gradients once."""
    per_key = {k: _layer_params(v) if isinstance(v, dict) else v.unbind(0)
               for k, v in tree.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[li] for k, v in per_key.items()} for li in range(n)]


def _embed(params: Params, tokens: torch.Tensor,
           tracer: Tracer = _UNTRACED) -> torch.Tensor:
    """The token embedding lookup, in the ``embed`` span."""
    with tracer.span("embed"):
        x = params["embed"][tokens.long()]
        tracer.sync(x)
    return x


def _layer_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 attend, tracer: Tracer = _UNTRACED, span_args=None,
                 recur=None, aux: List = None, remat: bool = False
                 ) -> torch.Tensor:
    """Run every layer on ``x``.  An attention layer: rmsnorm,
    ``attend(p_attn, xn, idx)`` (the attention output of layer ``idx``; it
    writes that layer's cache or pools), in a hybrid layer beside
    ``recur("ssm", p_ssm, xn, idx)`` and mean-fused with it after a
    rmsnorm of each, residual; then rmsnorm, the MLP or MoE FFN, residual.
    An xLSTM pair: ``recur("mlstm", ...)`` then ``recur("slstm", ...)``,
    each on its own rmsnorm with its own residual.  ``recur(block, p, xn,
    idx)`` returns the block's output and keeps its state as the pass
    needs.  ``aux`` collects the MoE layers' load-balance losses.  With an
    enabled ``tracer`` each module (``attention``, its span carrying
    ``span_args``; ``ssm``, ``mlstm``, ``slstm``; ``mlp``) runs in a span
    that closes after the device finished it.  With ``remat`` each layer
    runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` around its scanned layer body): only the layer's
    input is kept, and the backward runs the layer again.  Returns the
    hidden states before the final rmsnorm."""
    eps = cfg.norm_eps

    def block(name, p, xn, idx, args=None):
        with tracer.span(name, args=args):
            out = (attend(p, xn, idx) if name == "attention"
                   else recur(name, p, xn, idx))
            tracer.sync(out)
        return out

    def layer(x, idx, kind, p):
        """Layer ``idx`` of ``kind`` with parameters ``p`` (this layer's
        slice of its group): (its output, its MoE loss or None)."""
        if kind == "xlstm_pair":
            for name, norm in (("mlstm", "m_norm"), ("slstm", "s_norm")):
                xn = rmsnorm(x, p[norm], eps)
                x = x + block(name, p[name], xn, idx)
            return x, None
        xn = rmsnorm(x, p["attn_norm"], eps)
        a_out = block("attention", p["attn"], xn, idx, span_args)
        if kind == "hybrid":
            s_out = block("ssm", p["ssm"], xn, idx)
            a_out = 0.5 * (rmsnorm(a_out, p["attn_out_norm"], eps)
                           + rmsnorm(s_out, p["ssm_out_norm"], eps))
        x = x + a_out
        loss = None
        if "mlp" in p:
            xn = rmsnorm(x, p["mlp_norm"], eps)
            with tracer.span("mlp"):
                if kind.endswith("moe"):
                    # the load-balance loss is for training
                    # (forward_hidden returns it); the serving steps drop
                    # it, as the reference's do
                    m_out, loss = mlp_mod.moe_apply(cfg, p["mlp"], xn)
                else:
                    m_out = mlp_mod.mlp_apply(cfg, p["mlp"], xn)
                tracer.sync(m_out)
            x = x + m_out
        return x, loss

    per_layer = [_layer_params(gp) for gp in params["groups"]]
    for idx, (kind, gi, li, _win) in enumerate(_layer_slots(cfg)):
        if remat:
            x, loss = checkpoint(layer, x, idx, kind, per_layer[gi][li],
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            x, loss = layer(x, idx, kind, per_layer[gi][li])
        if loss is not None and aux is not None:
            aux.append(loss)
    return x


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor,
            rows: torch.Tensor = None,
            tracer: Tracer = _UNTRACED) -> torch.Tensor:
    """The final rmsnorm, then fp32 logits of one position per row: in-row
    index ``rows`` (B,), or position 0 when ``rows`` is None; in the
    ``lm_head`` span."""
    with tracer.span("lm_head"):
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        last = h[:, 0] if rows is None else \
            h[torch.arange(h.shape[0], device=h.device), rows.long()]
        logits = (last @ _lm_head(cfg, params)).float()
        tracer.sync(logits)
    return logits


def _full_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                caches: List[Cache] = None, aux: List = None,
                remat: bool = False) -> torch.Tensor:
    """Every layer over the whole (B, S) block at positions [0, S):
    attention through the flash-attention kernel (``gqa_full`` or
    ``mla_full``), the recurrent blocks' full-sequence scans.  With
    ``caches`` (the groups of ``init_cache``), each layer's cache entries
    are written there: K/V or the latent at [0, S), the recurrent states
    after the last token.  ``remat``: each layer under
    ``torch.utils.checkpoint``.  Returns the hidden states before the
    final rmsnorm."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    slots = _layer_slots(cfg)

    def attend(p_attn, xn, idx):
        kind, gi, li, win = slots[idx]
        full = attn.mla_full if kind.startswith("mla") else attn.gqa_full
        out, entries = full(cfg, p_attn, xn, positions, win)
        if caches is not None:
            for key, val in entries.items():
                caches[gi][key][li, :, :S] = val
        return out

    def recur(block, p, xn, idx):
        _kind, gi, li, _win = slots[idx]
        forward, _decode, sub, _keys = _RECURRENT[block]
        out, state = forward(cfg, p, xn)
        if caches is not None:
            holder = caches[gi][sub] if sub else caches[gi]
            for key, val in state.items():
                holder[key][li] = val
        return out

    return _layer_stack(cfg, params, x, attend, recur=recur, aux=aux,
                        remat=remat)


def prefill(cfg: ModelConfig, params: Params, batch: Dict, max_seq: int,
            lengths: torch.Tensor = None) -> Tuple[torch.Tensor, Cache]:
    """Process the full prompt block (``embed_inputs``: B rows of S
    positions, a vision prefix included) with dense attention (the
    flash-attention kernel per attention layer) and the recurrent blocks'
    scans; returns (last-token logits (B, vocab) fp32, dense caches: K/V
    or the MLA latent at positions [0, S) and zeros up to ``max_seq``,
    recurrent states as the scans left them, ``pos`` = lengths).
    ``lengths`` (B,) marks true lengths of right-padded rows (default S);
    as in the reference, the recurrent states have run over the padding
    too."""
    x = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    caches = init_cache(cfg, B, max_seq, x.device)["groups"]
    h = _full_stack(cfg, params, x, caches)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    logits = _logits(cfg, params, h, lengths - 1)
    return logits, {"groups": caches, "pos": lengths.to(torch.int32)}


def forward_hidden(cfg: ModelConfig, params: Params, batch: Dict,
                   remat: bool = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final hidden states (B, S, d) after the final rmsnorm, and the
    MoE layers' summed load-balance loss (fp32 scalar; 0 without MoE):
    the training path and the encoder's entry point (hubert has no decode
    step).  ``remat`` (default ``cfg.remat``) runs each layer under
    activation checkpointing when autograd records (grad mode on): the
    values are the same either way."""
    remat = cfg.remat if remat is None else remat
    x = embed_inputs(cfg, params, batch)
    aux: List[torch.Tensor] = []
    h = _full_stack(cfg, params, x, aux=aux,
                    remat=remat and torch.is_grad_enabled())
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for loss in aux:
        total = total + loss
    return rmsnorm(h, params["final_norm"], cfg.norm_eps), total


def _chunk_nll(h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One loss chunk: (the summed cross-entropy of its labelled
    positions, their count), logits in fp32, labels -1 masked."""
    logits = (h @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - tgt) * mask).sum(), mask.sum()


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Chunked causal-LM (or frame-classification) cross-entropy, as the
    reference computes it: ``forward_hidden`` (remat per ``cfg.remat``); a
    vlm's hidden states cut to its text labels; the positions padded to a
    whole number of ``cfg.loss_chunk`` chunks with label -1; per chunk the
    fp32 logits' logsumexp less the label's logit, summed over labelled
    positions; loss = mean + 0.01 * the MoE aux loss.  Returns (loss,
    {"nll", "aux", "tokens"})."""
    h, aux = forward_hidden(cfg, params, batch)
    labels = batch["labels"].long()            # (B, S_out), -1 = pad
    B, S, d = h.shape
    if labels.shape[1] != S:                   # vlm: labels only for text
        h = h[:, S - labels.shape[1]:]
        S = labels.shape[1]
    head = _lm_head(cfg, params)
    chunk = min(cfg.loss_chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    hp = torch.nn.functional.pad(h, (0, 0, 0, pad))
    lp = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        cut = slice(i * chunk, (i + 1) * chunk)
        nll, n = _chunk_nll(hp[:, cut], lp[:, cut], head)
        total = total + nll
        count = count + n
    nll = total / torch.clamp(count, min=1.0)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux, "tokens": count}


def _nest(flat: Dict[Tuple[str, ...], torch.Tensor]) -> Cache:
    """{key path: tensor} as nested dicts."""
    out: Cache = {}
    for path, t in flat.items():
        d = out
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = t
    return out


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step for all rows against dense caches.  tokens: (B, 1)
    int.  ``cfg.decode_impl`` selects the cache update, as in the
    reference: "carry" writes each layer's token K/V (or latent) and its
    recurrent states in place into the given stacked caches (which the
    returned cache holds); "stacked" leaves them as they were and returns
    new stacked caches.  Returns (logits (B, vocab) fp32, cache with
    ``pos`` + 1).  Encoder-only configs have no decode step."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name}: encoder-only archs have no decode "
                         f"step (use forward_hidden)")
    pos = cache["pos"]
    groups = cache["groups"]
    slots = _layer_slots(cfg)
    carry = cfg.decode_impl == "carry"
    # "stacked": each group's new per-layer entries by key path
    stacked: List[Dict[Tuple[str, ...], list]] = [{} for _ in groups]

    def keep(gi, path, val):
        stacked[gi].setdefault(path, []).append(val)

    def attend(p_attn, xn, idx):
        kind, gi, li, win = slots[idx]
        g = groups[gi]
        mla = kind.startswith("mla")
        keys = ("ckv", "krope") if mla else ("k", "v")
        if carry:
            fn = attn.mla_decode_carry if mla else attn.gqa_decode_carry
            return fn(cfg, p_attn, xn, g[keys[0]], g[keys[1]], li, pos,
                      win)[0]
        fn = attn.mla_decode if mla else attn.gqa_decode
        out, c = fn(cfg, p_attn, xn, {k: g[k][li] for k in keys}, pos, win)
        for k in keys:
            keep(gi, (k,), c[k])
        return out

    def recur(block, p, xn, idx):
        _kind, gi, li, _win = slots[idx]
        _forward, decode, sub, keys = _RECURRENT[block]
        holder = groups[gi][sub] if sub else groups[gi]
        out, new = decode(cfg, p, xn, {k: holder[k][li] for k in keys})
        for k in keys:
            if carry:
                holder[k][li] = new[k]
            else:
                keep(gi, (sub, k) if sub else (k,), new[k])
        return out

    h = _layer_stack(cfg, params, _embed(params, tokens), attend,
                     recur=recur)
    logits = _logits(cfg, params, h)
    if not carry:
        groups = [_nest({k: torch.stack(v) for k, v in g.items()})
                  for g in stacked]
    return logits, {"groups": groups, "pos": pos + 1}


def _paged_chunk_forward(cfg: ModelConfig, params: Params,
                         kpool: torch.Tensor, vpool: torch.Tensor,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         starts: torch.Tensor, write_slots: torch.Tensor,
                         write_offs: torch.Tensor, tokens: torch.Tensor,
                         last_idx: torch.Tensor,
                         tracer: Tracer = _UNTRACED, span_args=None
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

    h = _layer_stack(cfg, params, _embed(params, tokens, tracer), attend,
                     tracer, span_args)
    return _logits(cfg, params, h, last_idx, tracer), kpool, vpool


def _paged_chunk_forward_traced(cfg: ModelConfig, params: Params,
                                kpool: torch.Tensor, vpool: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor, starts: torch.Tensor,
                                write_slots: torch.Tensor,
                                write_offs: torch.Tensor,
                                tokens: torch.Tensor, last_idx: torch.Tensor,
                                tracer: Tracer, span_args=None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Instrumented twin of ``_paged_chunk_forward``: the same operations,
    with one device-synchronised span per module."""
    return _paged_chunk_forward(cfg, params, kpool, vpool, block_tables,
                                lengths, starts, write_slots, write_offs,
                                tokens, last_idx, tracer, span_args)


def paged_decode_step(cfg: ModelConfig, params: Params,
                      kpool: torch.Tensor, vpool: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      write_slot: torch.Tensor, write_off: torch.Tensor,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      tracer: Tracer = _UNTRACED, span_args=None
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

    h = _layer_stack(cfg, params, _embed(params, tokens, tracer), attend,
                     tracer, span_args)
    return _logits(cfg, params, h, tracer=tracer), kpool, vpool


def paged_decode_step_traced(cfg: ModelConfig, params: Params,
                             kpool: torch.Tensor, vpool: torch.Tensor,
                             block_tables: torch.Tensor,
                             lengths: torch.Tensor, write_slot: torch.Tensor,
                             write_off: torch.Tensor, tokens: torch.Tensor,
                             pos: torch.Tensor, tracer: Tracer,
                             span_args=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Instrumented twin of ``paged_decode_step``: the same operations,
    with one device-synchronised span per module (``embed``, per layer
    ``attention`` and ``mlp``, ``lm_head``), so the durations are module
    latencies.  The engine runs it when its module probe is on; the
    attention spans carry ``span_args`` (``{"heads": h, "cache_bytes":
    g}``), from which the profiler fits tau(h, g)."""
    return paged_decode_step(cfg, params, kpool, vpool, block_tables,
                             lengths, write_slot, write_off, tokens, pos,
                             tracer, span_args)


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


def paged_prefill_chunk_traced(cfg: ModelConfig, params: Params,
                               kpool: torch.Tensor, vpool: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, starts: torch.Tensor,
                               write_slots: torch.Tensor,
                               write_offs: torch.Tensor,
                               tokens: torch.Tensor, last_idx: torch.Tensor,
                               tracer: Tracer, span_args=None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Instrumented twin of ``paged_prefill_chunk`` (see
    ``paged_decode_step_traced``)."""
    assert supports_paged_prefill(cfg), \
        "config not supported by paged prefill"
    return _paged_chunk_forward_traced(cfg, params, kpool, vpool,
                                       block_tables, lengths, starts,
                                       write_slots, write_offs, tokens,
                                       last_idx, tracer, span_args)


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


def paged_fused_step_traced(cfg: ModelConfig, params: Params,
                            kpool: torch.Tensor, vpool: torch.Tensor,
                            block_tables: torch.Tensor,
                            lengths: torch.Tensor, starts: torch.Tensor,
                            write_slots: torch.Tensor,
                            write_offs: torch.Tensor, tokens: torch.Tensor,
                            last_idx: torch.Tensor, tracer: Tracer,
                            span_args=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Instrumented twin of ``paged_fused_step`` (see
    ``paged_decode_step_traced``): decode and prefill rows run in the one
    call, under the one set of module spans."""
    assert supports_fused_step(cfg), "config not supported by fused step"
    return _paged_chunk_forward_traced(cfg, params, kpool, vpool,
                                       block_tables, lengths, starts,
                                       write_slots, write_offs, tokens,
                                       last_idx, tracer, span_args)


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
               anchor_sink: int, exchange, step, marks=None):
    """Run ``step(anchor kpool, anchor vpool) -> logits`` over per-device
    pool shards: stage remote pages into the anchor pool, run the
    single-pool step on it, write dirty staged pages back.  ``exchange``
    is ``(g_dev, g_src, g_dst, w_dev, w_src, w_dst)``.  ``marks``, four
    timing events or None, are recorded on the current stream at the
    start, after the exchange in, before the exchange out and at the end
    (``serving.graphs.CallClock``; inside a capture each is a node of the
    graph).  Returns (logits, kpools, vpools); the pools are updated in
    place."""
    g_dev, g_src, g_dst, w_dev, w_src, w_dst = exchange
    if marks is not None:
        marks[0].record()
    ak, av = _pool_exchange_in(kpools, vpools, anchor, anchor_sink,
                               g_dev, g_src, g_dst)
    if marks is not None:
        marks[1].record()
    logits = step(ak, av)
    if marks is not None:
        marks[2].record()
    kpools, vpools = _pool_exchange_out(kpools, vpools, anchor, anchor_sink,
                                        w_dev, w_src, w_dst)
    if marks is not None:
        marks[3].record()
    return logits, kpools, vpools


def sharded_fused_step(cfg: ModelConfig, params: Params,
                       kpools: Pools, vpools: Pools, anchor: int,
                       anchor_sink: int, g_dev, g_src, g_dst, w_dev, w_src,
                       w_dst, block_tables, lengths, starts, write_slots,
                       write_offs, tokens, last_idx, marks=None):
    """``paged_fused_step`` over per-device pool shards.  Block tables and
    write slots are ANCHOR-pool indices built by ``PoolStepPlan``.
    Returns (logits, kpools, vpools); the pools are updated in place."""
    assert supports_fused_step(cfg), "config not supported by fused step"
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_fused_step(
            cfg, params, ak, av, block_tables, lengths, starts, write_slots,
            write_offs, tokens, last_idx)[0],
        marks)


def sharded_decode_step(cfg: ModelConfig, params: Params,
                        kpools: Pools, vpools: Pools, anchor: int,
                        anchor_sink: int, g_dev, g_src, g_dst, w_dev, w_src,
                        w_dst, block_tables, lengths, write_slot, write_off,
                        tokens, pos, marks=None):
    """``paged_decode_step`` over per-device pool shards; the writeback
    lanes carry the remote rows' decode-token page back to its shard.
    Returns (logits, kpools, vpools); the pools are updated in place."""
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_decode_step(
            cfg, params, ak, av, block_tables, lengths, write_slot,
            write_off, tokens, pos)[0],
        marks)


def sharded_prefill_chunk(cfg: ModelConfig, params: Params,
                          kpools: Pools, vpools: Pools, anchor: int,
                          anchor_sink: int, g_dev, g_src, g_dst, w_dev,
                          w_src, w_dst, block_tables, lengths, starts,
                          write_slots, write_offs, tokens, last_idx,
                          marks=None):
    """``paged_prefill_chunk`` over per-device pool shards.
    Returns (logits, kpools, vpools); the pools are updated in place."""
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_prefill_chunk(
            cfg, params, ak, av, block_tables, lengths, starts, write_slots,
            write_offs, tokens, last_idx)[0],
        marks)


def sharded_fused_step_traced(cfg: ModelConfig, params: Params,
                              kpools: Pools, vpools: Pools, anchor: int,
                              anchor_sink: int, g_dev, g_src, g_dst, w_dev,
                              w_src, w_dst, block_tables, lengths, starts,
                              write_slots, write_offs, tokens, last_idx,
                              tracer: Tracer, span_args=None):
    """Instrumented twin of ``sharded_fused_step`` (the exchange around
    the traced single-pool body)."""
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_fused_step_traced(
            cfg, params, ak, av, block_tables, lengths, starts, write_slots,
            write_offs, tokens, last_idx, tracer, span_args)[0])


def sharded_decode_step_traced(cfg: ModelConfig, params: Params,
                               kpools: Pools, vpools: Pools, anchor: int,
                               anchor_sink: int, g_dev, g_src, g_dst, w_dev,
                               w_src, w_dst, block_tables, lengths,
                               write_slot, write_off, tokens, pos,
                               tracer: Tracer, span_args=None):
    """Instrumented twin of ``sharded_decode_step``."""
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_decode_step_traced(
            cfg, params, ak, av, block_tables, lengths, write_slot,
            write_off, tokens, pos, tracer, span_args)[0])


def sharded_prefill_chunk_traced(cfg: ModelConfig, params: Params,
                                 kpools: Pools, vpools: Pools, anchor: int,
                                 anchor_sink: int, g_dev, g_src, g_dst,
                                 w_dev, w_src, w_dst, block_tables, lengths,
                                 starts, write_slots, write_offs, tokens,
                                 last_idx, tracer: Tracer, span_args=None):
    """Instrumented twin of ``sharded_prefill_chunk``."""
    return _on_anchor(
        kpools, vpools, anchor, anchor_sink,
        (g_dev, g_src, g_dst, w_dev, w_src, w_dst),
        lambda ak, av: paged_prefill_chunk_traced(
            cfg, params, ak, av, block_tables, lengths, starts, write_slots,
            write_offs, tokens, last_idx, tracer, span_args)[0])
